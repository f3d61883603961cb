"""hibag_tpu_torch.ops.scoring held against hibag_tpu.ops.scoring on the
same seeded inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibag_tpu.ops import scoring as ref
from hibag_tpu_torch.ops import scoring as port

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _classifier(seed, H=40, L=128, A=14, N=24, n_snp=20):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (H, L)).astype(np.float32)
    bits[:, n_snp:] = 0
    freq = rng.random(H).astype(np.float32)
    freq[H - 5:] = 0  # padded slots
    freq[freq > 0] /= freq[freq > 0].sum()
    allele = np.sort(rng.integers(0, A, H)).astype(np.int32)
    geno = rng.integers(0, 4, (N, L)).astype(np.int8)
    geno[:, n_snp:] = 3
    geno[:2] = 3  # all-missing samples
    return bits, freq, allele, geno, A


@pytest.mark.parametrize("seed", [0, 1])
def test_coefficients_and_distance_exact(seed):
    bits, _, _, geno, _ = _classifier(seed)
    for a, b in zip(ref.geno_coefficients(jnp.asarray(geno)),
                    port.geno_coefficients(torch.from_numpy(geno))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    D_ref = ref.pair_distance(jnp.asarray(bits), jnp.asarray(geno))
    D = port.pair_distance(torch.from_numpy(bits), torch.from_numpy(geno))
    np.testing.assert_array_equal(D.numpy(), np.asarray(D_ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_posterior_scores_f32(seed):
    bits, freq, allele, geno, A = _classifier(seed)
    r = ref.posterior_scores(jnp.asarray(bits), jnp.asarray(freq),
                             jnp.asarray(allele), jnp.asarray(geno), A)
    p = port.posterior_scores(torch.from_numpy(bits), torch.from_numpy(freq),
                              torch.from_numpy(allele), torch.from_numpy(geno),
                              A)
    np.testing.assert_array_equal(p["dmin"].numpy(), np.asarray(r["dmin"]))
    np.testing.assert_allclose(p["S"].numpy(), np.asarray(r["S"]), rtol=2e-4,
                               atol=1e-30)
    np.testing.assert_allclose(p["total"].numpy(), np.asarray(r["total"]),
                               rtol=2e-4)


def test_posterior_scores_f64():
    bits, freq, allele, geno, A = _classifier(2)
    freq = freq.astype(np.float64)
    with jax.enable_x64(True):
        r = ref.posterior_scores(jnp.asarray(bits), jnp.asarray(freq),
                                 jnp.asarray(allele), jnp.asarray(geno), A,
                                 f64=True)
        r = {k: np.asarray(v) for k, v in r.items()}
    p = port.posterior_scores(torch.from_numpy(bits), torch.from_numpy(freq),
                              torch.from_numpy(allele), torch.from_numpy(geno),
                              A, f64=True)
    assert p["S"].dtype == torch.float64 and r["S"].dtype == np.float64
    np.testing.assert_array_equal(p["dmin"].numpy(), r["dmin"])
    np.testing.assert_allclose(p["S"].numpy(), r["S"], rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(p["total"].numpy(), r["total"], rtol=1e-12)


@pytest.mark.parametrize("inplace", [False, True])
def test_unordered_from_S_exact(inplace):
    S = np.random.default_rng(3).random((4, 7, 7)).astype(np.float32)
    St = torch.from_numpy(S.copy())
    got = port.unordered_from_S(St, inplace=inplace)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.unordered_from_S(jnp.asarray(S))))
    assert (got.data_ptr() == St.data_ptr()) == inplace
