"""B7's arithmetic order, mirrored on the CPU, against the reference.

``check.wkv6_stepped`` computes the RWKV-6 WKV recurrence in the order
of f32 operations that ``csrc/wkv6_scan.cu`` uses (tokens in pairs, the
second token's query and the first's key carried through the pair's
decays, the bonus folded out as β_t v_t, a thread's rows of the state
tile summed by an FMA chain, the lanes of a column group by the
reduce-scatter's tree), with the tile the kernel picks for the width
and row count (``check.wkv6_tile``).
It is held against the reference's Pallas kernel in interpret mode
(``wkv6_fwd``) and its oracle (``ref.wkv6_ref``) on the same
numpy-seeded inputs, at the reference's B7 tolerance (atol 3e-5, as
tests/test_kernels.py and tests/test_torch_two_stage.py), at widths 4
to 128 and 1 to 300 tokens, with decays drawn as the reference's model
draws them: exact zeros among them, and a padded tail of w = 1, k = 0.
The CUDA kernel itself runs only on the card, where
tests/test_torch_cuda.py holds it against this order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.wkv6_scan import wkv6_fwd
from repro_torch.kernels import check

torch.set_num_threads(1)
WKV_ATOL = 3e-5
H100_SMS = 132
# (dh, the card's SM count): the reference's own kernel-test width (4)
# and rwkv6-7b's reduced one (16), rwkv6-7b's 64 with both tiles the
# kernel picks between (three rows are many on a card of one SM, few on
# an H100), an uneven width and the widest the kernel takes
TILES = [(4, H100_SMS), (16, H100_SMS), (64, 1), (64, H100_SMS),
         (100, H100_SMS), (128, H100_SMS)]


def _reference(r, k, v, w, u):
    """(Pallas kernel in interpret mode, oracle) outputs as numpy."""
    n, l, dh = r.shape
    x = [jnp.asarray(a.numpy()) for a in (r, k, v, w, u)]
    exp_k = wkv6_fwd(*x, chunk=256, interpret=True)
    exp_r, _ = ref.wkv6_ref(*x, jnp.zeros((n, dh, dh), jnp.float32))
    return np.asarray(exp_k), np.asarray(exp_r)


def _close(got, exp):
    np.testing.assert_allclose(got.numpy(), exp, atol=WKV_ATOL, rtol=0)


@pytest.mark.parametrize("l", [1, 50, 300])
@pytest.mark.parametrize("dh,sms", TILES)
def test_kernel_order_matches_reference(dh, sms, l):
    """Three rows (their padded tails 0, L/8 and 2L/8 tokens long), model
    decays with exact zeros."""
    args = check.make_wkv6_inputs("cpu", 3, l, dh, seed=l + dh,
                                  decays="model")
    got = check.wkv6_stepped(*args, sms)
    assert got.dtype == torch.float32 and got.shape == (3, l, dh)
    exp_k, exp_r = _reference(*args)
    _close(got, exp_k)
    _close(got, exp_r)


@pytest.mark.parametrize("dh,sms", [(16, H100_SMS), (64, 1),
                                    (100, H100_SMS)])
def test_kernel_order_at_decays_of_zero_and_one(dh, sms):
    """Every decay exactly 0 or 1 (a state wiped, a state carried whole),
    where the stepped form is exact term by term."""
    r, k, v, _, u = check.make_wkv6_inputs("cpu", 3, 64, dh, seed=dh)
    w = torch.tensor(np.random.default_rng(dh).integers(
        0, 2, size=r.shape).astype(np.float32))
    got = check.wkv6_stepped(r, k, v, w, u, sms)
    exp_k, exp_r = _reference(r, k, v, w, u)
    _close(got, exp_k)
    _close(got, exp_r)


@pytest.mark.parametrize("n,dh,sms,tile", [
    (3, 4, H100_SMS, (2, 8)), (3, 16, H100_SMS, (2, 8)),
    (3, 32, H100_SMS, (4, 8)), (3, 64, 1, (8, 8)),
    (3, 64, H100_SMS, (4, 16)), (131, 64, H100_SMS, (4, 16)),
    (132, 64, H100_SMS, (8, 8)), (264, 33, H100_SMS, (8, 8)),
    (512, 100, H100_SMS, (8, 16)), (3, 128, H100_SMS, (8, 16))])
def test_tile_rule(n, dh, sms, tile):
    """The tile by width and row count: at dh 33..64 the many-row tile
    once the rows give the card four of its warps a SM."""
    assert check.wkv6_tile(n, dh, sms) == tile


def test_model_decays_hold_exact_zeros_and_a_padded_tail():
    """The decays the cases above draw: exact zeros, w in [0, 1), and on
    row i a tail of (i % 3) · L/8 tokens with w = 1 and k = 0."""
    r, k, v, w, u = check.make_wkv6_inputs("cpu", 3, 64, 64, seed=0,
                                           decays="model")
    assert int((w[:, :48] == 0).sum()) > 0
    assert bool((w[0] < 1).all())
    for i, tail in enumerate((0, 8, 16)):
        assert bool((w[i, 64 - tail:] == 1).all())
        assert bool((k[i, 64 - tail:] == 0).all())
        assert bool((k[i, :64 - tail] != 0).all())
