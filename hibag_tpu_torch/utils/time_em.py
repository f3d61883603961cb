"""Times the EM step kernels of the checkout in the current directory on
one CUDA card, at the shapes where the bit-packed kernel's launches happen.

    python3 path/to/time_em.py LABEL [PAIR_LIST ...]

Run from the root of a checkout (this tree or an older one, e.g. a
`git archive` copy of the parent commit): it imports that checkout's
`hibag_tpu_torch` and `chip_smoke.py`. For each of the training slice's
step (K=8, S=1,024, H=256, C=17), the headline training step (K=25, S=64,
H=128, C=32) and a re-seated mid-scale classifier (K=1, S=1,000, H=512,
C=17) it checks `em_estep_packed` against its plain version and prints
three 10-launch means (CUDA events, so the wrapper's host time counts where
it exceeds the card's), and each CUDA kernel's device time per launch under
torch.profiler; `em_estep` too at the slice's shape. Each PAIR_LIST given
times the packed kernel once more with that list size (a keyword of this
tree's wrapper) and checks that its results are bitwise the default's.
"""

import os
import sys

import numpy as np
import torch


def main(argv):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hibag_tpu_torch.ops import train_step as ts
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    label = argv[1] if len(argv) > 1 else "tree"
    sizes = [int(x) for x in argv[2:]]
    dev, card = cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng(11)
    for K, C, H, A, S in ((8, 17, 256, 14, 1024), (25, 32, 128, 14, 64),
                          (1, 17, 512, 14, 1000)):
        c = cs._train_case(rng, K, C, H, A, S, dev, n_sel=16)
        calls = cs._em_calls(c)
        shape = f"K={K} C={C} H={H} S={S}"
        runs = [("em_estep_packed", {})] + [("em_estep_packed",
                                             {"pair_list": n}) for n in sizes]
        if K == 8:
            runs.append(("em_estep", {}))
        base = calls["em_estep_packed"][0](*calls["em_estep_packed"][2])
        for name, kw in runs:
            kern, ref, args = calls[name]
            got = kern(*args, **kw)
            ok = all(torch.allclose(x, y, rtol=1e-4, atol=1e-9)
                     for x, y in zip(got, ref(*args)))
            if kw:
                ok = ok and all(torch.equal(x, y) for x, y in zip(got, base))
            ms = [cs._cuda_ms(lambda: kern(*args, **kw), 10) for _ in range(3)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    kern(*args, **kw)
                torch.cuda.synchronize()
            split = {e.key.replace("(anonymous namespace)::", "")
                     .split("(")[0][-40:]:
                     round(e.self_device_time_total / 1e3 / e.count, 4)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA}
            print(f"TIME {label} {name}{kw or ''} {shape}: "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms, checked {ok}; "
                  f"device ms per launch {split} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
