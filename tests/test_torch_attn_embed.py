"""K7: the port's ``round1_logits`` / ``round2_logits`` held to the JAX
package's Pallas kernels (``ops/pallas/experimental/attn_embed.py``, run in
interpret mode on the CPU) on the same seeded inputs, at real widths (128
hidden, 16 coordinates).  On the CPU the port's wrappers run their plain
versions.  Both sides take bf16 operands with f32 sums and differ in the
order of the f32 sums only; but a hidden activation whose f32 value lies
next to a bf16 rounding boundary then rounds to the neighbouring bf16 value
(2^-8 relative) on one side, which moves that token's logit by up to ~1e-3
of the largest logit.  So each logit is held to 1e-3 of the largest
magnitude, and their mean error to 1e-5 of it.  Ragged T and N (not multiples of the JAX block
of 2048, nor of the port's 16-token tiles) are included.  The kernel-vs-plain
checks on the card are at the end, marked ``cuda``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from coponerf_tpu.ops.pallas.experimental import attn_embed as jax_ae
from coponerf_tpu_torch.ops import attn_embed as ae

H, L = 128, 16


def _weights(rng, ze_rows: bool = False):
    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out = dict(wq=w(L, H, scale=0.5), bq=w(H, scale=0.1), wq2=w(H, H, scale=H ** -0.5), bq2=w(H, scale=0.1))
    if ze_rows:
        out.update(wra=w(H, H, scale=H ** -0.5), wrb=w(L, H, scale=0.5), br=w(H, scale=0.1),
                   wr2=w(H, H, scale=H ** -0.5), br2=w(H, scale=0.1))
    else:
        out.update(fk_bias=w(H, scale=0.1), wk2=w(H, H, scale=H ** -0.5), bk2=w(H, scale=0.1))
    return out


def _bf16(rng, *shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale).astype(jnp.bfloat16)


def _t(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


def _close(got: torch.Tensor, ref) -> None:
    ref = ref.float().cpu() if isinstance(ref, torch.Tensor) else torch.as_tensor(np.asarray(ref, dtype=np.float32))
    got = got.float().cpu()
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    top = ref.abs().max().item()
    err = (got - ref).abs()
    assert err.max().item() <= 1e-3 * top, (err.max().item(), top)
    assert err.mean().item() <= 1e-5 * top, (err.mean().item(), top)


@pytest.mark.parametrize("R, T", [(2, 4096), (2, 2500), (1, 37)])
def test_round1_logits_matches_jax(R, T):
    rng = np.random.default_rng(T)
    ka, kbs = _bf16(rng, R, T, H), _bf16(rng, R, T, H)
    lc = _bf16(rng, R, T, L)
    w = _weights(rng)
    ref = jax_ae.round1_logits(ka, kbs, lc, *(jnp.asarray(w[k]) for k in
                                             ("fk_bias", "wk2", "bk2", "wq", "bq", "wq2", "bq2")))
    ka_t, kbs_t = _t(ka).bfloat16(), _t(kbs).bfloat16()
    got = ae.round1_logits(ka_t, kbs_t, _t(lc), *(torch.from_numpy(w[k]) for k in
                                                 ("fk_bias", "wk2", "bk2", "wq", "bq", "wq2", "bq2")))
    assert got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("B, V, S, N", [(1, 2, 4, 1024), (2, 2, 3, 300), (1, 2, 2, 2053), (2, 2, 4, 777)])
def test_round2_logits_matches_jax(B, V, S, N):
    rng = np.random.default_rng(N)
    ze = jnp.asarray(rng.standard_normal((B, N, H)).astype(np.float32))
    lc = _bf16(rng, B * V, S * N, L)
    w = _weights(rng, ze_rows=True)
    names = ("wq", "bq", "wq2", "bq2", "wra", "wrb", "br", "wr2", "br2")
    ref = jax_ae.round2_logits(ze, lc, *(jnp.asarray(w[k]) for k in names), S=S, V=V)
    got = ae.round2_logits(_t(ze), _t(lc), *(torch.from_numpy(w[k]) for k in names), S, V)
    assert got.shape == (B * V, S * N)
    _close(got, ref)


def test_cpu_wrappers_count_no_launch():
    rng = np.random.default_rng(0)
    w1, w2 = _weights(rng), _weights(rng, ze_rows=True)
    before = (ae.round1_logits.launches, ae.round2_logits.launches)
    ae.round1_logits(torch.randn(2, 16, H).bfloat16(), torch.randn(2, 16, H).bfloat16(), torch.randn(2, 16, L),
                     *(torch.from_numpy(w1[k]) for k in ("fk_bias", "wk2", "bk2", "wq", "bq", "wq2", "bq2")))
    ae.round2_logits(torch.randn(1, 8, H), torch.randn(2, 16, L),
                     *(torch.from_numpy(w2[k]) for k in ("wq", "bq", "wq2", "bq2", "wra", "wrb", "br", "wr2", "br2")),
                     2, 2)
    assert (ae.round1_logits.launches, ae.round2_logits.launches) == before


# ------------------------------------------- kernels vs plain, on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_weights(gen, dev, ze_rows: bool):
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    return {k: torch.from_numpy(v).to(dev) for k, v in _weights(rng, ze_rows).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16 * 4096, 1000, 7])
def test_round1_kernel_matches_plain(cuda, T):
    """Same bf16 operands, f32 sums in another order (module docstring)."""
    g = torch.Generator().manual_seed(T)
    ka = torch.randn(2, T, H, generator=g).bfloat16().to(cuda)
    kbs = torch.randn(2, T, H, generator=g).bfloat16().to(cuda)
    lc = torch.randn(2, T, L, generator=g).to(cuda)
    w = _cuda_weights(g, cuda, False)
    args = (ka, kbs, lc, *(w[k] for k in ("fk_bias", "wk2", "bk2", "wq", "bq", "wq2", "bq2")))
    n = ae.round1_logits.launches
    got = ae.round1_logits(*args)
    assert ae.round1_logits.launches == n + 1
    _close(got, ae.round1_logits_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, N", [(1, 16, 4096), (2, 4, 1000), (1, 3, 7), (1, 4, 32768), (2, 4, 4097)])
def test_round2_kernel_matches_plain(cuda, B, S, N):
    """Same bf16 operands, f32 sums in another order (module docstring).
    The kernel takes 64 rays a warpgroup: (1, 4, 32768) is the render's
    stage B, (2, 4, 4097) and (2, 4, 1000) end in a partial 64-ray unit."""
    g = torch.Generator().manual_seed(N)
    ze = torch.randn(B, N, H, generator=g).to(cuda)
    lc = torch.randn(2 * B, S * N, L, generator=g).to(cuda)
    w = _cuda_weights(g, cuda, True)
    args = (ze, lc, *(w[k] for k in ("wq", "bq", "wq2", "bq2", "wra", "wrb", "br", "wr2", "br2")))
    n = ae.round2_logits.launches
    got = ae.round2_logits(*args, S, 2)
    assert ae.round2_logits.launches == n + 1
    _close(got, ae.round2_logits_plain(*args, S, 2))
