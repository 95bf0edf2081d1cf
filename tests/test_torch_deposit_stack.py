"""Port parity: the stacked drizzle deposit (kernel B1's one-launch form)
vs the JAX package's per-plane deposit.

``subpixal_tpu_torch.ops.drizzle.drizzle_deposit_stack`` deposits E
planes with one pscale ratio each and sums them. It is held to the sum of
``subpixal_tpu.ops.drizzle.drizzle_deposit`` over the same numpy planes,
for all seven drizzle kernels, planes at ratios 1.0, 0.5 and 2.0, and a
plane whose zero-weight pixels sit at NaN positions. Each plane's
accumulators agree to ``ATOL`` (float32 evaluations of the same per-cell
formulas, scatter sums in another order), so the sum over E planes is
held to ``E * ATOL``. The stacked plain version must equal the loop of
single-plane deposits summed in order bit for bit: the align step's CPU
numbers do not change with the stacked call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.ops.drizzle import drizzle_deposit as j_deposit
from subpixal_tpu_torch.kernels import drizzle as kdrizzle
from subpixal_tpu_torch.ops.drizzle import (DRIZZLE_KERNELS, drizzle_deposit,
                                            drizzle_deposit_stack)

torch.set_num_threads(2)

#: one plane's accumulators hold O(10) values: a few float32 ulps
ATOL = 2e-5

RATIOS = (1.0, 0.5, 2.0, 1.0)


def _stack(seed=0, H=18, W=22):
    """Four planes at RATIOS: data, weights (some zero) and rotated,
    scaled, offset pixmaps; the last plane's zero-weight pixels have NaN
    positions."""
    rng = np.random.default_rng(seed)
    E = len(RATIOS)
    data = rng.uniform(0.5, 3.0, (E, H, W)).astype(np.float32)
    wht = rng.uniform(0.5, 1.5, (E, H, W)).astype(np.float32)
    wht[rng.random((E, H, W)) < 0.15] = 0.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xo = np.empty((E, H, W), np.float32)
    yo = np.empty((E, H, W), np.float32)
    for e, r in enumerate(RATIOS):
        th = np.deg2rad(5.0 * e - 4.0)
        xo[e] = r * (np.cos(th) * xx - np.sin(th) * yy) + 3.3 + 0.4 * e
        yo[e] = r * (np.sin(th) * xx + np.cos(th) * yy) + 4.1 - 0.3 * e
    wht[-1, ::3, ::2] = 0.0
    xo[-1][wht[-1] == 0.0] = np.nan
    yo[-1, ::5][wht[-1, ::5] == 0.0] = np.nan
    n = int(2.0 * (H + W)) + 12
    return data, wht, xo, yo, (n, n)


@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
@pytest.mark.parametrize("pixfrac", [1.0, 0.8])
def test_stack_matches_sum_of_jax_deposits(kernel, pixfrac):
    data, wht, xo, yo, oshape = _stack()
    js = jw = 0.0
    for e, r in enumerate(RATIOS):
        s, w = j_deposit(jnp.asarray(data[e]), jnp.asarray(wht[e]),
                         jnp.asarray(xo[e]), jnp.asarray(yo[e]), oshape,
                         pixfrac=pixfrac, pscale_ratio=r, kernel=kernel)
        js, jw = js + np.asarray(s), jw + np.asarray(w)
    ts, tw = drizzle_deposit_stack(
        *(torch.from_numpy(a) for a in (data, wht, xo, yo)), oshape,
        pixfrac=pixfrac, pscale_ratio=RATIOS, kernel=kernel)
    tol = len(RATIOS) * ATOL
    assert np.isfinite(ts.numpy()).all() and np.isfinite(tw.numpy()).all()
    np.testing.assert_allclose(ts.numpy(), js, atol=tol)
    np.testing.assert_allclose(tw.numpy(), jw, atol=tol)
    assert float(tw.sum()) > 0


@pytest.mark.parametrize("kernel", ["square", "lanczos3"])
def test_stack_is_the_ordered_sum_of_plane_deposits(kernel):
    """Bit for bit: the stack sums planes e = 0..E-1 in that order."""
    t = [torch.from_numpy(a) for a in _stack(seed=1)[:4]]
    oshape = _stack(seed=1)[4]
    sci = wht = None
    for e, r in enumerate(RATIOS):
        s, w = drizzle_deposit(t[0][e], t[1][e], t[2][e], t[3][e], oshape,
                               pixfrac=0.9, pscale_ratio=r, kernel=kernel)
        sci = s if sci is None else sci + s
        wht = w if wht is None else wht + w
    ss, sw = drizzle_deposit_stack(*t, oshape, pixfrac=0.9,
                                   pscale_ratio=RATIOS, kernel=kernel)
    assert torch.equal(ss, sci) and torch.equal(sw, wht)


def test_stack_unit_weights_and_one_plane():
    """``in_wht=None`` is unit weights; a stack of one is the single
    deposit."""
    data, wht, xo, yo, oshape = _stack(seed=2)
    t = [torch.from_numpy(a) for a in (data, xo, yo)]
    ones = torch.ones_like(t[0])
    a = drizzle_deposit_stack(t[0], None, t[1], t[2], oshape,
                              pscale_ratio=RATIOS)
    b = drizzle_deposit_stack(t[0], ones, t[1], t[2], oshape,
                              pscale_ratio=RATIOS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    one = drizzle_deposit_stack(t[0][:1], None, t[1][:1], t[2][:1], oshape,
                                pscale_ratio=(1.0,))
    single = drizzle_deposit(t[0][0], None, t[1][0], t[2][0], oshape)
    assert torch.equal(one[0], single[0]) and torch.equal(one[1], single[1])


def test_kernel_wrapper_on_cpu_is_the_plain_stack():
    """The B1 wrapper on CPU tensors is the plain stack, with (E,) int32
    ``escaped`` zeros; a ratio count that is not E, or an unknown kernel,
    raises."""
    t = [torch.from_numpy(a) for a in _stack(seed=3)[:4]]
    oshape = _stack(seed=3)[4]
    s, w, esc = kdrizzle.drizzle_deposit_stack(*t, oshape,
                                               pscale_ratio=RATIOS)
    ps, pw = drizzle_deposit_stack(*t, oshape, pscale_ratio=RATIOS)
    assert torch.equal(s, ps) and torch.equal(w, pw)
    assert esc.dtype == torch.int32 and esc.shape == (len(RATIOS),)
    assert int(esc.abs().sum()) == 0
    with pytest.raises(ValueError):
        kdrizzle.drizzle_deposit_stack(*t, oshape, pscale_ratio=(1.0,))
    with pytest.raises(ValueError):
        kdrizzle.drizzle_deposit_stack(*t, oshape, pscale_ratio=RATIOS,
                                       kernel="boxcar")


@pytest.mark.parametrize("kernel,ratios,Ks,cap", [
    ("square", (1.0,), [2], (2 + 2 + 4) * (128 + 2 + 4)),
    ("square", (1.0, 2.0), [2, 3], (4 + 3 + 4) * (256 + 3 + 4)),
    ("lanczos3", (2.0,), [13], kdrizzle._MAX_CELLS),
    ("point", (0.5,), [1], (1 + 1 + 4) * (64 + 1 + 4)),
])
def test_plane_params_and_window_size(kernel, ratios, Ks, cap):
    """The per-plane parameters the kernel reads (K first) and each warp's
    shared-memory window: the largest 2 x 128 strip footprint of the
    planes, (2r + K + 4) by (128r + K + 4) cells, capped at an eighth of
    227 KB (a larger window takes the direct-atomics path)."""
    prm, got = kdrizzle._plane_params(kernel, 1.0, ratios, "cpu")
    assert prm.shape == (len(ratios), 8) and prm.dtype == torch.float32
    assert [int(k) for k in prm[:, 0]] == Ks
    assert got == cap
