"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; every test here is marked ``cuda`` and
skips without a device. The file imports neither JAX nor the reference
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Inputs and tolerances come from ``repro_torch.kernels.check``, which
``chip_smoke.py`` uses too.
"""
import pytest
import torch

from repro_torch.kernels import check
from repro_torch.kernels import linear_attn_scan as kl
from repro_torch.kernels import prf_decode_step as kds
from repro_torch.kernels import prf_featmap as kf
from repro_torch.kernels import prf_fused_decode as kd
from repro_torch.kernels import prf_fused_prefill as kp
from repro_torch.kernels import wkv6_scan as kw


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,d,m,dv,dark,stab,dtype", [
    (8, 3, 3, 64, 256, 64, True, True, torch.float32),    # smollm-135m heads
    (8, 3, 3, 64, 256, 64, False, False, torch.float32),
    # the engine decodes only its active slots: 1, 2 and 5 of 8
    (1, 3, 3, 64, 256, 64, True, True, torch.bfloat16),
    (2, 3, 3, 64, 256, 64, True, False, torch.bfloat16),
    (5, 3, 3, 64, 256, 64, True, True, torch.bfloat16),
    (8, 3, 3, 64, 256, 64, True, True, torch.bfloat16),   # the main path's
    (4, 1, 8, 256, 256, 256, True, True, torch.float32),  # darkformer-2b
    (4, 1, 8, 256, 256, 256, False, True, torch.bfloat16),
    (3, 2, 2, 16, 32, 16, True, False, torch.float32),
    (2, 2, 3, 32, 64, 40, True, True, torch.float32),     # a partial tile
])
def test_decode_kernel_matches_plain(dev, b, g, hg, d, m, dv, dark, stab,
                                     dtype):
    """B1 against its plain version (f32 state and outputs within
    F32_TOL; outputs are f32 for bf16 inputs too)."""
    args = check.make_inputs(dev, b, g, hg, d, m, dv, None, dark, seed=b + m,
                             dtype=dtype)
    check.check_case("decode", lambda: kd.launches, kd.fused_prf_decode,
                     kd.prf_fused_decode_plain, args, (5, 6, 7),
                     stabilize=stab)


@pytest.mark.cuda
@pytest.mark.parametrize("c0", [40.0, -40.0])
def test_decode_kernel_owns_the_stabilizer(dev, c0):
    """c far above the new keys' maxima (rho = 1, c kept) and far below
    (rho = e^-40-ish, S and z all but replaced): launch 1 reads the old
    c and z and writes the new ones, launch 2 rescales S by the same
    rho."""
    args = check.make_inputs(dev, 8, 3, 3, 64, 256, 64, None, True, seed=3,
                             dtype=torch.bfloat16)
    args[7].fill_(c0)
    check.check_case("decode rho", lambda: kd.launches, kd.fused_prf_decode,
                     kd.prf_fused_decode_plain, args, (5, 6, 7), eps=1e-8)
    if c0 > 0:
        assert bool((args[7] == c0).all())
    else:
        assert bool((args[7] > -10).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_decode_kernel_updates_in_place_without_pool_copies(dev, b):
    """s, z and c stay where they lie, and the call allocates less than
    1 MB, the output and the scratch of features (0.1 MB at 8 slots), no
    copy of c or z: the 8-slot pool's S is 4.7 MB."""
    args = check.make_inputs(dev, b, 3, 3, 64, 256, 64, None, True, seed=b,
                             dtype=torch.bfloat16)
    s, z, c = args[5:]
    ptrs = [t.data_ptr() for t in (s, z, c)]
    kd.fused_prf_decode(*args, eps=1e-8)         # built and loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = kd.fused_prf_decode(*args, eps=1e-8)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    assert [t.data_ptr() for t in got[1:]] == ptrs
    assert extra < 2 ** 20, extra


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,d,m,dv,l,dark,stab,valid_len,chunk", [
    (8, 3, 3, 64, 256, 64, 512, True, True,
     (512, 0, 300, 257, 256, 1, 511, 100), 256),
    (8, 3, 3, 64, 256, 64, 32, False, False, None, 256),
    (4, 1, 8, 256, 256, 256, 300, True, True, (300, 0, 299, 17), 256),
    (3, 2, 2, 16, 32, 16, 20, True, False, (20, 5, 0), 256),
    # the other feature counts the kernel is built for
    (2, 1, 2, 32, 16, 32, 70, True, True, (70, 33), 256),
    (2, 2, 1, 64, 64, 64, 100, False, True, None, 256),
    (1, 1, 4, 128, 128, 128, 257, True, False, (257,), 256),
    # T-chunks of 100 tokens: two prefix steps, the second partial
    (2, 3, 3, 64, 256, 64, 250, True, True, (250, 130), 100),
])
def test_prefill_kernel_matches_plain(dev, b, g, hg, d, m, dv, l, dark,
                                      stab, valid_len, chunk):
    args = check.make_inputs(dev, b, g, hg, d, m, dv, l, dark, seed=b + l)
    vl = (None if valid_len is None
          else torch.tensor(valid_len, dtype=torch.int32, device=dev))
    check.check_case("prefill", lambda: kp.launches, kp.fused_prf_prefill,
                     kp.prf_fused_prefill_plain, args, (5, 6, 7), vl,
                     stabilize=stab, chunk=chunk)


@pytest.mark.cuda
def test_bf16_inputs_match_plain(dev):
    """The main path's input type: bf16 q/k/v, f32 state."""
    args = check.make_inputs(dev, 8, 3, 3, 64, 256, 64, 32, True, 1,
                             torch.bfloat16)
    vl = torch.tensor([32, 20, 1, 32, 7, 32, 32, 9], dtype=torch.int32,
                      device=dev)
    exp = kp.prf_fused_prefill_plain(*check.clone(args), vl, eps=1e-8)
    got = kp.fused_prf_prefill(*args, vl, eps=1e-8)
    assert got[0].dtype == torch.bfloat16
    # bf16 outputs within check.BF16_OUT_TOL, the state within F32_TOL
    check.max_error("prefill bf16", got, exp, vl)


# the serving packer's grants for smollm-135m at chunk_tokens=256 (rows x
# tokens), ragged; and L = 300, whose second T-chunk is partial
@pytest.mark.cuda
@pytest.mark.parametrize("b,l,valid_len", [
    (4, 64, (64, 1, 0, 40)),
    (2, 128, (128, 1)),
    (2, 128, (0, 77)),
    (1, 256, (256,)),
    (1, 256, (1,)),
    (1, 256, (0,)),
    (4, 300, (300, 0, 257, 1)),
])
def test_prefill_kernel_at_grant_shapes(dev, b, l, valid_len):
    """B2 at the main path's shapes and input type (bf16 q/k/v, f32
    state) against its plain version; rows with valid_len 0 keep their
    state bitwise."""
    args = check.make_inputs(dev, b, 3, 3, 64, 256, 64, l, True, seed=b + l,
                             dtype=torch.bfloat16)
    before = check.clone(args[5:])
    vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
    check.check_case("prefill grant", lambda: kp.launches,
                     kp.fused_prf_prefill, kp.prf_fused_prefill_plain, args,
                     (5, 6, 7), vl, eps=1e-8)
    for row, n in enumerate(valid_len):
        if n == 0:
            for got, old in zip(args[5:], before):
                assert torch.equal(got[row], old[row])


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(8, 32), (4, 64), (2, 128), (1, 256)])
def test_prefill_kernel_updates_in_place_without_pool_copies(dev, b, l):
    """s, z and c stay where they lie, and the call allocates less than the
    S of the engine's 8-slot pool (smollm-135m, 4.7 MB): the output and
    the chunk-sized scratch of raw logits, no snapshot of the state."""
    args = check.make_inputs(dev, b, 3, 3, 64, 256, 64, l, True, seed=l,
                             dtype=torch.bfloat16)
    s, z, c = args[5:]
    ptrs = [t.data_ptr() for t in (s, z, c)]
    pool_s_bytes = 8 * 3 * 3 * 256 * 64 * 4
    vl = torch.full((b,), l, dtype=torch.int32, device=dev)
    kp.fused_prf_prefill(*args, vl, eps=1e-8)    # built and loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = kp.fused_prf_prefill(*args, vl, eps=1e-8)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    assert [t.data_ptr() for t in got[1:]] == ptrs
    assert extra < pool_s_bytes, (extra, pool_s_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,hk,l,m,dv,dtype", [
    (8, 3, 3, 1, 512, 256, 64, torch.bfloat16),  # smollm-135m training
    (2, 3, 3, 1, 777, 256, 64, torch.float32),   # ragged last chunk
    (2, 1, 8, 1, 100, 256, 256, torch.float32),  # darkformer-2b heads
    (3, 2, 2, 1, 1, 32, 16, torch.float32),      # one token
    (1, 2, 3, 1, 256, 32, 80, torch.bfloat16),   # four chunks, dv > 64
    (4, 3, 3, 1, 64, 256, 64, torch.float32),    # one 64-key tile
    (4, 3, 3, 1, 65, 256, 64, torch.bfloat16),   # one key past it
    (2, 3, 3, 1, 2048, 256, 64, torch.bfloat16),  # 31 prefix states
    (2, 3, 3, 3, 300, 256, 64, torch.float32),   # kf, v per query head
    (1, 2, 5, 1, 130, 36, 12, torch.float32),    # 3 + 2 heads, narrow m, dv
    (1, 1, 2, 1, 70, 30, 10, torch.bfloat16),    # rows not 16-byte multiples
])
def test_linear_attention_kernel_matches_plain(dev, b, g, hg, hk, l, m, dv,
                                               dtype):
    """B5 forward and gradients against autograd of its plain version."""
    args = check.make_lin_attn_inputs(dev, b, g, hg, l, m, dv, seed=l,
                                      dtype=dtype, hk=hk)
    check.check_autograd(
        "linear_attention_causal", kl,
        lambda q, k, v: kl.linear_attention_causal(q, k, v, eps=1e-8),
        lambda q, k, v: kl.linear_attention_causal_plain(q, k, v, 1e-8),
        args, seed=l)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,r,m,dark,dtype", [
    (36_864, 64, 64, 256, True, torch.float32),   # smollm-135m training
    (1000, 64, 32, 256, True, torch.bfloat16),    # rows not a tile multiple
    (777, 64, 64, 256, False, torch.float32),     # isotropic
    (5, 16, 16, 32, True, torch.float32),
    # d_head 128 and darkformer-2b's 256 (the reference's widths)
    (4099, 128, 128, 256, True, torch.bfloat16),
    (4099, 256, 256, 256, True, torch.float32),
    (777, 256, 256, 256, False, torch.float32),
    (32_768, 256, 256, 256, True, torch.bfloat16),
    # the other kernels of the dispatch: streamed at d > r (r = 64, 128),
    # resident at r = 64 where W's split does not fit beside M
    (777, 128, 64, 256, True, torch.float32),
    (777, 256, 128, 256, True, torch.bfloat16),
    (777, 64, 64, 512, True, torch.float32),
])
def test_featmap_kernel_matches_plain(dev, n, d, r, m, dark, dtype):
    """B6 forward and gradients against autograd of its plain version."""
    args = check.make_featmap_inputs(dev, n, d, r, m, dark, seed=n,
                                     dtype=dtype)
    check.check_autograd("prf_featmap", kf, kf.prf_featmap,
                         kf.prf_featmap_plain, args, seed=n)


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,hk,m,dv,dtype", [
    # smollm-135m's heads at 1, 2, 4 and 8 active slots
    (8, 3, 3, 1, 256, 64, torch.float32),
    (8, 3, 3, 1, 256, 64, torch.bfloat16),
    (4, 3, 3, 1, 256, 64, torch.bfloat16),
    (2, 3, 3, 1, 256, 64, torch.float32),
    (1, 3, 3, 1, 256, 64, torch.bfloat16),
    # darkformer-2b's heads at 1 and 8 slots
    (8, 1, 8, 1, 256, 256, torch.float32),
    (8, 1, 8, 1, 256, 256, torch.bfloat16),
    (1, 1, 8, 1, 256, 256, torch.bfloat16),
    # kf, v and rho per query head (Hk = H)
    (2, 3, 3, 3, 256, 64, torch.float32),
    (2, 1, 8, 8, 256, 256, torch.bfloat16),
    (3, 2, 2, 1, 32, 8, torch.float32),    # dv within one tile
    (3, 2, 2, 2, 32, 8, torch.bfloat16),
])
def test_decode_step_kernel_matches_plain(dev, b, g, hg, hk, m, dv, dtype):
    """B3 against its plain version, S and z advanced where they lie."""
    args = check.make_decode_step_inputs(dev, b, g, hg, m, dv, seed=b + m,
                                         hk=hk, dtype=dtype)
    check.check_case("prf_decode_step", lambda: kds.launches,
                     kds.linear_attention_decode_step,
                     kds.prf_decode_step_plain, args, (3, 4), eps=1e-8)


# B4's cases: (B, G, Hg, Hk, L, m, dv, v dtype, rho < 1)
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,hk,l,m,dv,dtype,rho", [
    (2, 3, 3, 1, 1, 256, 64, F32, False),
    (2, 3, 3, 3, 37, 256, 64, F32, False),
    (2, 3, 3, 1, 256, 256, 64, BF16, False),
    (2, 3, 3, 1, 300, 256, 64, F32, False),
    (2, 3, 3, 3, 512, 256, 64, BF16, False),
    # rho < 1: the stabilizer's rescale, folded into the kernel
    (2, 3, 3, 1, 37, 256, 64, BF16, True),
    (2, 3, 3, 3, 300, 256, 64, F32, True),
    # the packer's four grants at smollm-135m's heads
    (8, 3, 3, 1, 32, 256, 64, BF16, True),
    (8, 3, 3, 1, 32, 256, 64, F32, True),
    (4, 3, 3, 1, 64, 256, 64, BF16, True),
    (2, 3, 3, 1, 128, 256, 64, F32, True),
    (1, 3, 3, 1, 256, 256, 64, BF16, True),
    (1, 3, 3, 1, 256, 256, 64, F32, True),
    # darkformer-2b's heads
    (8, 1, 8, 1, 32, 256, 256, F32, True),
    (1, 1, 8, 1, 256, 256, 256, BF16, True),
    # narrow, ragged widths: rows not 16-byte multiples, dv > 64
    (1, 2, 3, 1, 70, 30, 10, BF16, True),
    (1, 2, 3, 1, 45, 32, 80, F32, True),
    # the packer's smaller calls (PERF.md section 5's histogram) and a
    # chunk shorter than 32
    (3, 3, 3, 1, 64, 256, 64, BF16, True),
    (5, 3, 3, 1, 32, 256, 64, BF16, True),
    (2, 3, 3, 1, 64, 256, 64, F32, True),
    (1, 3, 3, 1, 128, 256, 64, BF16, True),
    (2, 3, 3, 1, 5, 256, 64, F32, True),
])
def test_carry_kernel_matches_plain(dev, b, g, hg, hk, l, m, dv, dtype,
                                    rho):
    """B4 against its plain version from a nonzero carried state, with kf
    and v per KV group (Hk = 1) or per head, optionally scaled by rho per
    query row, the state advanced in place."""
    args = check.make_carry_inputs(dev, b, g, hg, hk, l, m, dv, seed=l,
                                   dtype=dtype)
    kw = {"rho": check.make_carry_rho(dev, b, g, hg, seed=l)} if rho else {}
    check.check_case("linear_attention_carry", lambda: kl.carry_launches,
                     kl.linear_attention_prefill_chunk,
                     kl.linear_attention_carry_plain, args, (3, 4),
                     eps=1e-8, **kw)


@pytest.mark.cuda
def test_carry_kernel_chained_chunks_match_single_pass(dev):
    """Three uneven resumed chunks through B4 against one plain pass."""
    check.check_carry_chained(dev, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,dh,dtype,decays", [
    (16, 512, 64, torch.float32, "sigmoid"),
    (5, 50, 64, torch.bfloat16, "sigmoid"),
    (3, 1, 64, torch.float32, "sigmoid"),
    (4, 33, 16, torch.float32, "sigmoid"),
    # the reference's own kernel-test width (4), rwkv6-7b's reduced one
    # (16), an uneven width and the widest the kernel takes
    (4, 50, 4, torch.float32, "model"),
    (6, 77, 16, torch.bfloat16, "model"),
    (4, 300, 100, torch.float32, "model"),
    (4, 300, 128, torch.float32, "sigmoid"),
    (4, 300, 128, torch.bfloat16, "model"),
    # one long prompt at rwkv6-7b's 64 heads; a batch with exact zeros
    (64, 4096, 64, torch.float32, "sigmoid"),
    (64, 512, 64, torch.float32, "model"),
    (64, 512, 64, torch.bfloat16, "model"),
    # dh above 64 at more rows than the card has SMs: a row's columns
    # split over blocks to keep each within the kernel's 512 threads
    (512, 64, 128, torch.float32, "sigmoid"),
    (256, 64, 100, torch.bfloat16, "model")])
def test_wkv6_kernel_matches_plain(dev, n, l, dh, dtype, decays):
    """B7 forward and gradients against autograd of its plain version;
    ``decays="model"``: w as the reference's model draws it, with exact
    zeros and a padded tail of w = 1, k = 0."""
    args = check.make_wkv6_inputs(dev, n, l, dh, seed=l, dtype=dtype,
                                  decays=decays)
    check.check_autograd("wkv6", kw, kw.wkv6, kw.wkv6_plain, args, seed=l)


# f32 outputs of B7 and of its order mirrored (``check.wkv6_stepped``):
# 2^-25 of the largest output. The two agree bit for bit but where the
# mirror's FMA through f64 rounds twice (1.5e-8 at most in these cases
# on an H100); the plain version's order of the same sums parts from
# the kernel by 4.8e-7 to 1.2e-6 here (outputs up to about 4.6), 3 to 9
# times this tolerance.
ORDER_RTOL = 2 ** -25


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,dh", [
    (3, 300, 4), (4, 77, 32), (160, 64, 64), (16, 300, 64),
    (64, 1000, 64), (256, 64, 100), (512, 64, 128)])
def test_wkv6_kernel_follows_its_stepped_order(dev, n, l, dh):
    """B7 against ``check.wkv6_stepped`` with the tile ``check.wkv6_tile``
    gives for this card (every tile the kernel has, the columns split
    over blocks or not): the kernel's order of f32 operations, held
    tighter than another order of the same sums could meet."""
    args = check.make_wkv6_inputs(dev, n, l, dh, seed=n + l + dh,
                                  decays="model")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.no_grad():
        got = kw.wkv6(*args)
        exp = check.wkv6_stepped(*args, sms)
        plain = kw.wkv6_plain(*args)
    err = (got - exp).abs().max().item()
    tol = ORDER_RTOL * exp.abs().max().item()
    assert err <= tol, (f"kernel vs its order: {err:.3e} > {tol:.3e} "
                        f"(vs plain: {(got - plain).abs().max().item():.3e})")


@pytest.mark.cuda
def test_wkv6_kernel_launches_nothing_on_empty_input(dev):
    """No rows or no tokens: an empty output, and no launch counted."""
    for n, l in ((0, 5), (2, 0)):
        args = check.make_wkv6_inputs(dev, n, l, 16, seed=0)
        n0 = kw.launches
        o = kw.wkv6(*args)
        assert o.shape == (n, l, 16) and kw.launches == n0


@pytest.mark.cuda
def test_wkv6_kernel_refuses_dh_above_128(dev):
    """The kernel holds S in registers up to dh 128; above, the wrapper
    raises, naming the limit, and launches nothing."""
    args = check.make_wkv6_inputs(dev, 2, 5, 129, seed=0)
    n0 = kw.launches
    with pytest.raises(ValueError, match="128"):
        kw.wkv6(*args)
    assert kw.launches == n0


@pytest.mark.cuda
def test_two_stage_decode_step_launches_b3(dev):
    """A ``use_kernel`` decode step with ``fused=False`` on CUDA tensors
    runs B3 once per layer and the fused kernel never."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_config("smollm-135m", reduced=True, use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    st = lm.init_serve_state(cfg, b=2, max_len=32, per_slot=True,
                             device=dev)
    toks = torch.tensor([[1, 2, 3], [4, 5, 6]], device=dev)
    lm.prefill_chunk(params, cfg, {"tokens": toks}, st, fused=False)
    n3, n1 = kds.launches, kd.launches
    logits, _ = lm.decode_step(params, cfg, toks[:, 0], st, fused=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert kds.launches == n3 + cfg.n_layers
    assert kd.launches == n1


@pytest.mark.cuda
def test_overlapped_engine_matches_sequential(dev):
    """At full width on the card, the overlapped engine's greedy streams
    equal the sequential one's where the chunk schedule agrees (one
    staged row per prefill call), and its steps make no synchronising
    call but retire's event wait."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, synthetic_requests
    cfg = configs.get_config("smollm-135m", use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=4, max_len=512,
                            chunk_tokens=64, prefill_rows=1, overlap=overlap,
                            device=dev)
        reqs = synthetic_requests(6, cfg.vocab, seed=2,
                                  prompt_range=(16, 160), gen_range=(8, 16))
        uids = [eng.submit(r) for r in reqs]
        if overlap:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = {r.uid: r.tokens for r in eng.run()}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        streams.append([got[u] for u in uids])
        assert eng.stats["decode_path"] == "fused_kernel"
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]


@pytest.mark.cuda
def test_pack_buffer_never_overwrites_a_pending_copy(dev):
    """The third pack reuses the first buffer while its copy still waits
    behind a long kernel: it must wait for that copy, so each device
    copy holds the tokens packed for it."""
    from repro_torch.serving.slots import PackBuffer
    pb = PackBuffer(2, 4096, dev)
    torch.cuda._sleep(100_000_000)          # keep the copies pending
    a = pb.to_device(pb.pack([[1] * 1000, [2] * 1000], 1024))
    b = pb.to_device(pb.pack([[3] * 1000], 1024))
    pb.pack([[4] * 1000], 1024)
    assert pb.fence_waits == 1
    torch.cuda.synchronize()
    assert a[:, :1000].tolist() == [[1] * 1000, [2] * 1000]
    assert b[:, :1000].tolist() == [[3] * 1000]
    assert not a[:, 1000:].any() and not b[:, 1000:].any()


def _exact_cfg(**kw):
    from repro_torch import configs
    return configs.darkify(configs.get_config("smollm-135m", **kw), "exact")


@pytest.mark.cuda
def test_exact_chunk_and_decode_match_cpu(dev):
    """The exact kind (no kernel) on the card against the port's CPU run,
    same params: a ragged chunk and two decode steps, logits and every
    layer's KV cache within 1e-4 (f32 through 3 layers, TF32 off), the
    cache lengths equal."""
    from repro_torch.models import lm
    cfg = _exact_cfg(reduced=True)
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 9),
                         generator=torch.Generator().manual_seed(1))
    runs = []
    for d in ("cpu", dev):
        p = lm.tree_map(lambda t: t.to(d), params)
        st = lm.init_serve_state(cfg, b=3, max_len=32, per_slot=True,
                                 device=d)
        logits, st = lm.prefill_chunk(
            p, cfg, {"tokens": toks.to(d)}, st,
            valid_len=torch.tensor([9, 4, 6], dtype=torch.int32, device=d))
        out = [logits.cpu()]
        for i in range(2):
            logits, st = lm.decode_step(p, cfg, toks[:, i].to(d), st)
            out.append(logits.cpu())
        runs.append((out, {k: t.cpu() for k, t in
                           st["layers"]._asdict().items()}))
    (cpu_out, cpu_st), (card_out, card_st) = runs
    for a, b in zip(card_out, cpu_out):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert torch.equal(card_st["length"], cpu_st["length"])
    for name in ("kv_k", "kv_v"):
        torch.testing.assert_close(card_st[name], cpu_st[name], atol=1e-4,
                                   rtol=0)


@pytest.mark.cuda
def test_exact_ragged_write_at_cache_end(dev):
    """A padded chunk running past the cache's end (12 + 8 > 16): on the
    card each row writes [length, length + valid_len) and leaves every
    other position bitwise as it was, as on the CPU; the outputs agree
    within 1e-5."""
    from repro_torch.core import attention as rfa
    gen = torch.Generator().manual_seed(2)
    b, g, hg, d, lmax, l = 3, 2, 2, 8, 16, 8
    qs = torch.randn((b, g, hg, l, d), generator=gen)
    ks = torch.randn((b, g, 1, l, d), generator=gen)
    v = torch.randn((b, g, 1, l, d), generator=gen)
    kc = torch.randn((b, g, lmax, d), generator=gen)
    vc = torch.randn((b, g, lmax, d), generator=gen)
    length = torch.tensor([12, 13, 8], dtype=torch.int32)
    vl = torch.tensor([3, 2, 8], dtype=torch.int32)
    runs = []
    for where in ("cpu", dev):
        st = rfa.KVCacheState(kc.clone().to(where), vc.clone().to(where),
                              length.clone().to(where))
        out, st = rfa._exact_prefill_resume(
            qs.to(where), ks.to(where), v.to(where), st, None,
            torch.float32, valid_len=vl.to(where))
        runs.append((out.cpu(), st.kv_k.cpu(), st.kv_v.cpu(),
                     st.length.cpu()))
    (o_cpu, k_cpu, v_cpu, n_cpu), (o_card, k_card, v_card, n_card) = runs
    assert torch.equal(k_card, k_cpu) and torch.equal(v_card, v_cpu)
    assert n_card.tolist() == [15, 15, 16]
    assert torch.equal(n_card, n_cpu)
    torch.testing.assert_close(o_card, o_cpu, atol=1e-5, rtol=0)
    for r in range(b):
        lo, hi = int(length[r]), int(length[r] + vl[r])
        assert torch.equal(k_card[r, :, :lo], kc[r, :, :lo])
        assert torch.equal(k_card[r, :, hi:], kc[r, :, hi:])
        assert torch.equal(k_card[r, :, lo:hi], ks[r, :, 0, :hi - lo])


@pytest.mark.cuda
def test_overlapped_exact_engine_matches_sequential(dev):
    """An exact smollm-135m at full width: the overlapped engine's greedy
    streams equal the sequential one's at one staged row per prefill
    call, its steps make no synchronising call but retire's event wait,
    and no kernel launches."""
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, synthetic_requests
    cfg = _exact_cfg(use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    before = (kd.launches, kp.launches, kds.launches)
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=4, max_len=512,
                            chunk_tokens=64, prefill_rows=1, overlap=overlap,
                            device=dev)
        reqs = synthetic_requests(6, cfg.vocab, seed=2,
                                  prompt_range=(16, 160), gen_range=(8, 16))
        uids = [eng.submit(r) for r in reqs]
        if overlap:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = {r.uid: r.tokens for r in eng.run()}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        streams.append([got[u] for u in uids])
        assert eng.stats["decode_path"] == "exact"
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]
    assert (kd.launches, kp.launches, kds.launches) == before
