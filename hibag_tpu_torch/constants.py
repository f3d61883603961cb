"""Algorithm constants shared with the reference implementation.

These mirror the reference's bit-identity targets (reference
src/LibHLA.cpp:98-116, inst/include/LibHLA_ext.h:221-230) — they are part of
the *algorithm definition*, not implementation details.
"""

import numpy as np

#: maximum number of SNPs in a single classifier (LibHLA_ext.h:221)
MAXNUM_SNP = 128

#: minimum haplotype frequency; also the per-mismatch likelihood penalty base
#: (LibHLA_ext.h:230)
MIN_RARE_FREQ = 1e-5

#: log of the penalty base: penalty(d) = exp(d * LOG_MIN_RARE_FREQ)
LOG_MIN_RARE_FREQ = float(np.log(MIN_RARE_FREQ))

#: EM iteration cap (src/LibHLA.cpp:100)
EM_MAX_ITERATIONS = 500

#: initial frequency fraction for newly doubled haplotypes (src/LibHLA.cpp:102)
EM_INIT_VAL_FRAC = 0.001

#: EM convergence relative tolerance (src/LibHLA.cpp:98)
EM_FUNC_RELTOL = float(np.sqrt(np.finfo(np.float64).eps))

#: fraction used for initial haplotype-count heuristic (src/LibHLA.cpp:104)
FRACTION_HAPLO = 1.0 / 10

#: stop greedy SNP addition when relative log-lik improvement below this
#: (src/LibHLA.cpp:114)
STOP_RELTOL_LOGLIK_ADDSNP = 0.001

#: pruning relative tolerance (src/LibHLA.cpp:116)
PRUNE_RELTOL_LOGLIK = 0.1

#: genotype code for missing (internal; reference packs missing as planes (0,1))
GENO_MISSING = 3


def penalty_table(dtype=np.float64) -> np.ndarray:
    """EXP_LOG_MIN_RARE_FREQ equivalent: ``1e-5 ** d`` for d in [0, 256].

    Non-finite/underflowed entries are exactly 0, matching the reference's
    table construction (src/LibHLA.cpp:167-189).
    """
    n = 2 * MAXNUM_SNP
    with np.errstate(under="ignore"):
        t = np.exp(np.arange(n + 1) * np.log(MIN_RARE_FREQ))
    t[0] = 1.0
    t[~np.isfinite(t)] = 0.0
    return t.astype(dtype)
