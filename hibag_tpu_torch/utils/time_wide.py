"""Times the packed EM kernel and the evaluation kernel at a wide locus's
sample count, past 4,096 haplotype slots, on one CUDA card.

    python3 -m hibag_tpu_torch.utils.time_wide

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py`). At 1,000 samples, 17 candidates and H = 4,160 and 10,016
slots it builds `chip_smoke._train_case`'s seeded inputs (two untyped
samples, whose every slot pair is set; the others typed), holds each kernel
against its plain version (EM at rtol 1e-4; counts exact, -2logLik at rtol
1e-4) and prints the kernel's time (CUDA events, mean of 3 after a warm-up),
the plain version's (one run) and the bound from the inputs: the packed EM
(bit-packed mask, the tier `models/em.py::mask_tier` picks at these sizes)
at K=1, A=14; the evaluation at K=2, A=160. The bit-packed mask at H=10,016
is 12.5 GB.
"""

import os
import sys

import numpy as np
import torch

#: (K, C, H, A, S) of the packed EM and the evaluation
SHAPES = {"em_estep_packed": [(1, 17, H, 14, 1000) for H in (4160, 10016)],
          "evaluate_candidates_kernel": [(2, 17, H, 160, 1000)
                                         for H in (4160, 10016)]}


def main(argv):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hibag_tpu_torch.ops import train_step as ts

    dev, card = cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng(12)
    for name, shapes in SHAPES.items():
        for shape in shapes:
            is_em = name == "em_estep_packed"
            c = cs._train_case(rng, *shape, dev,
                               masks="packed" if is_em else False)
            if is_em:
                kern, ref = ts.em_estep_packed, ts.em_estep_packed_ref
                args = (c["fA"], c["fB"], c["packed"], c["gc"], c["B"],
                        1000.0)
            else:
                kern, ref, args = cs._eval_call(c)
            label = "K={} C={} H={} A={} S={}".format(*shape)
            out, out2 = kern(*args), kern(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = ref(*args)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            if not all(torch.equal(x, y) for x, y in zip(out, out2)):
                raise AssertionError(f"{name} {label}: two runs differ")
            if is_em:
                err = max(cs._close(f"{name} {label}", x, y, rtol=1e-4,
                                    atol=1e-9)[0] for x, y in zip(out, want))
            else:
                if not torch.equal(out[0], want[0]):
                    raise AssertionError(f"{name} {label}: counts differ")
                err = cs._close(f"{name} {label} ll", out[1], want[1],
                                rtol=1e-4, atol=1e-6)[0]
            ms = cs._cuda_ms(lambda: kern(*args), 3)
            bound = cs._train_bound(name, c)
            print(f"[wide-times] {name} {label}: max abs err {err:.3e}, "
                  f"bitwise deterministic; {ms:.4f} ms (CUDA events, mean "
                  f"of 3), plain {plain_ms:.4f} ms (one run), bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) | "
                  f"{card}", flush=True)
            del c, args, out, out2, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
