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
    # d_head 128 at m 256: granite-8b's (8, 4), yi-34b's (8, 7),
    # qwen3-32b's (8, 8) and qwen3-moe-235b-a22b's (4, 16) KV groups
    (8, 8, 4, 128, 256, 128, True, True, torch.bfloat16),
    (3, 8, 7, 128, 256, 128, True, True, torch.bfloat16),
    (8, 8, 7, 128, 256, 128, True, False, torch.float32),
    (8, 8, 8, 128, 256, 128, True, True, torch.bfloat16),
    (8, 4, 16, 128, 256, 128, True, True, torch.bfloat16),
    (1, 4, 16, 128, 256, 128, True, True, torch.float32),
    # recurrentgemma-2b's local layers: 10 query heads on one KV head,
    # d_head = m = dv = 256
    (8, 1, 10, 256, 256, 256, True, True, torch.bfloat16),
    (8, 1, 10, 256, 256, 256, True, False, torch.float32),
    (1, 1, 10, 256, 256, 256, True, True, torch.float32),
    (3, 1, 10, 256, 256, 256, False, True, torch.bfloat16),
    # hubert-xlarge's MHA: 16 KV groups of one head, d_head = dv = 80
    # (no path decodes it: the encoder runs no kernel)
    (8, 16, 1, 80, 256, 80, True, True, torch.float32),
    (8, 16, 1, 80, 256, 80, True, True, torch.bfloat16),
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


# the packer's four grants at d_head 128, m 256, dv 128 and the KV groups
# of granite-8b (8, 4), yi-34b (8, 7), qwen3-32b (8, 8) and
# qwen3-moe-235b-a22b (4, 16), ragged
D128_GROUPS = [(8, 4), (8, 7), (8, 8), (4, 16)]
D128_GRANTS = check.PACKER_GRANTS


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,valid_len", D128_GRANTS)
@pytest.mark.parametrize("g,hg", D128_GROUPS)
def test_prefill_kernel_at_d128_heads(dev, g, hg, b, l, valid_len):
    """B2 at the new configs' heads and the main path's input type (bf16
    q/k/v, f32 state), each grant of the packer."""
    args = check.make_inputs(dev, b, g, hg, 128, 256, 128, l, True,
                             seed=b + l + hg, dtype=torch.bfloat16)
    vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
    check.check_case("prefill d128", lambda: kp.launches,
                     kp.fused_prf_prefill, kp.prf_fused_prefill_plain, args,
                     (5, 6, 7), vl, eps=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,valid_len", D128_GRANTS)
def test_prefill_kernel_at_recurrentgemma_heads(dev, b, l, valid_len,
                                                dtype):
    """B2 at recurrentgemma-2b's local layers (G 1, Hg 10, d_head = m =
    dv = 256: r at the kernel's widest, 164 352 bytes of logits block),
    each grant of the packer, f32 and bf16 q/k/v."""
    args = check.make_inputs(dev, b, 1, 10, 256, 256, 256, l, True,
                             seed=b + l + 10, dtype=dtype)
    vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
    check.check_case("prefill recurrentgemma", lambda: kp.launches,
                     kp.fused_prf_prefill, kp.prf_fused_prefill_plain, args,
                     (5, 6, 7), vl, eps=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,valid_len", [
    (4, 320, None), (4, 512, None), (4, 512, (512, 320, 257, 511))])
def test_prefill_kernel_at_internvl2_vlm_prefill(dev, b, l, valid_len,
                                                 dtype):
    """B2 at internvl2-76b's heads (G 8, Hg 8, d_head = dv = 128, m 256)
    over a whole VLM prompt in one call, 256 patches and 64 or 256 text
    tokens: L = 320 and 512, two 256-token T-chunks with the carried
    state rescaled by rho between them, from a non-zero carried state,
    f32 and bf16 q/k/v."""
    args = check.make_inputs(dev, b, 8, 8, 128, 256, 128, l, True,
                             seed=l + b, dtype=dtype)
    vl = (None if valid_len is None
          else torch.tensor(valid_len, dtype=torch.int32, device=dev))
    check.check_case("prefill internvl2", lambda: kp.launches,
                     kp.fused_prf_prefill, kp.prf_fused_prefill_plain, args,
                     (5, 6, 7), vl, eps=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,valid_len", D128_GRANTS)
def test_prefill_kernel_at_hubert_heads(dev, b, l, valid_len, dtype):
    """B2 at hubert-xlarge's heads (G 16, Hg 1, d_head = dv = 80, m 256),
    each grant of the packer; no path prefills it through B2 (the
    encoder runs no kernel), so this holds the geometry alone."""
    args = check.make_inputs(dev, b, 16, 1, 80, 256, 80, l, True,
                             seed=b + l + 80, dtype=dtype)
    vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
    check.check_case("prefill hubert", lambda: kp.launches,
                     kp.fused_prf_prefill, kp.prf_fused_prefill_plain, args,
                     (5, 6, 7), vl, eps=1e-8)


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
    # d_head 128 at m 256: the KV groups of granite-8b, yi-34b, qwen3-32b
    # and qwen3-moe-235b-a22b
    (2, 8, 4, 1, 512, 256, 128, torch.bfloat16),
    (1, 8, 7, 1, 300, 256, 128, torch.float32),
    (1, 8, 8, 1, 256, 256, 128, torch.bfloat16),
    (1, 4, 16, 1, 512, 256, 128, torch.bfloat16),
    # recurrentgemma-2b's local layers: 10 query heads on one KV head,
    # m = dv = 256
    (2, 1, 10, 1, 512, 256, 256, torch.bfloat16),
    (1, 1, 10, 1, 300, 256, 256, torch.float32),
    # hubert-xlarge's MHA (16 groups of one head, dv 80): the geometry
    # alone, as its noncausal training runs no kernel
    (2, 16, 1, 1, 512, 256, 80, torch.bfloat16),
    (1, 16, 1, 1, 300, 256, 80, torch.float32),
    # internvl2-76b's training heads at 256 patches + 256 tokens
    (2, 8, 8, 1, 512, 256, 128, torch.float32),
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
    # d_head 128 at m 256: granite-8b's, yi-34b's, qwen3-32b's and
    # qwen3-moe-235b-a22b's KV groups
    (8, 8, 4, 1, 256, 128, torch.bfloat16),
    (8, 8, 7, 1, 256, 128, torch.float32),
    (3, 8, 7, 1, 256, 128, torch.bfloat16),
    (8, 8, 8, 1, 256, 128, torch.bfloat16),
    (8, 4, 16, 1, 256, 128, torch.bfloat16),
    (2, 4, 16, 16, 256, 128, torch.float32),
    # recurrentgemma-2b's local layers (G 1, Hg 10, dv 256)
    (8, 1, 10, 1, 256, 256, torch.bfloat16),
    (8, 1, 10, 1, 256, 256, torch.float32),
    (1, 1, 10, 1, 256, 256, torch.bfloat16),
    # hubert-xlarge's MHA (16 groups of one head, dv 80)
    (8, 16, 1, 1, 256, 80, torch.float32),
    (8, 16, 1, 1, 256, 80, torch.bfloat16),
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
    # d_head 128 at m 256: the four grants at granite-8b's, yi-34b's,
    # qwen3-32b's and qwen3-moe-235b-a22b's KV groups
    (8, 8, 4, 1, 32, 256, 128, BF16, True),
    (4, 8, 7, 1, 64, 256, 128, F32, True),
    (2, 8, 8, 1, 128, 256, 128, BF16, True),
    (1, 4, 16, 1, 256, 256, 128, BF16, True),
    (8, 4, 16, 1, 32, 256, 128, F32, False),
    # the four grants at recurrentgemma-2b's local layers (G 1, Hg 10,
    # dv 256)
    (8, 1, 10, 1, 32, 256, 256, BF16, True),
    (4, 1, 10, 1, 64, 256, 256, F32, True),
    (2, 1, 10, 1, 128, 256, 256, BF16, True),
    (1, 1, 10, 1, 256, 256, 256, F32, True),
    # hubert-xlarge's MHA (16 groups of one head, dv 80)
    (4, 16, 1, 1, 64, 256, 80, F32, True),
    (1, 16, 1, 1, 256, 256, 80, BF16, True),
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



def _shared_prefix_traffic(vocab, n=6, seed=4):
    """Requests that all open with one 64-token prefix (private suffixes
    of 8-40 tokens), and the primer that caches it: its cursor lands on
    64 at chunk_tokens 32 or 64."""
    from repro_torch.serving import Request, shared_prefix_requests
    reqs = shared_prefix_requests(n, vocab, seed=seed, prefix_len=64,
                                  reuse=1.0, suffix_range=(8, 40),
                                  gen_range=(6, 12))
    primer = Request(prompt=list(reqs[0].prompt[:64]) + [1, 2, 3],
                     max_new_tokens=2)
    return primer, reqs


def _primed_run(eng, primer, reqs, sync_error=False):
    """Serve the primer, then ``reqs`` (under sync-debug "error" if
    asked). Returns (their greedy streams in submission order, the
    engine's stats after the primer, B1's and B2's launches in the
    run)."""
    import copy
    eng.submit(copy.copy(primer))
    eng.run()
    before = dict(eng.stats)
    uids = [eng.submit(copy.copy(r)) for r in reqs]
    n1, n2 = kd.launches, kp.launches
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = {r.uid: r.tokens for r in eng.run()}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return ([got[u] for u in uids], before,
            (kd.launches - n1, kp.launches - n2))


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_forked_prf_streams_match_cold_start(dev, overlap):
    """The reduced smollm-135m through the kernels with a prefix cache:
    every request forks the primed 64-token prefix and prefills only its
    suffix, through B2 from the seeded state (B2 launches once a layer a
    prefill call, and the prefilled tokens are exactly the suffixes); the
    greedy streams equal a cache-less engine's at one staged row per
    prefill call, and the overlapped steps make no synchronising call
    but retire's event wait."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCacheConfig, ServingEngine
    cfg = configs.get_config("smollm-135m", reduced=True, use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    primer, reqs = _shared_prefix_traffic(cfg.vocab)
    streams = []
    for cache in (None, PrefixCacheConfig(block_tokens=16, page_size=16)):
        eng = ServingEngine(params, cfg, max_slots=3, max_len=128,
                            chunk_tokens=32, prefill_rows=1, overlap=overlap,
                            prefix_cache=cache, device=dev)
        got, before, (b1, b2) = _primed_run(eng, primer, reqs,
                                            sync_error=overlap)
        streams.append(got)
        st = eng.stats
        assert st["decode_path"] == "fused_kernel"
        assert b2 == (st["prefill_calls"] - before["prefill_calls"]
                      ) * cfg.n_layers
        assert b1 == (st["decode_steps"] - before["decode_steps"]
                      ) * cfg.n_layers
        if cache is not None:
            assert st["forked_requests"] - before["forked_requests"] == 6
            assert (st["prefill_tokens"] - before["prefill_tokens"]
                    == sum(len(r.prompt) - 64 for r in reqs))
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]


@pytest.mark.cuda
def test_snapshot_demotion_and_promotion_round_trip(dev):
    """A full-width smollm-135m snapshot (S, z, c, pos) demoted into
    pinned host memory and promoted back, both behind a long kernel so
    the copies are still pending when they are enqueued: no call waits,
    and after the stream drains the host copy and the promoted state are
    bitwise the snapshot. Through the store, a device budget of one
    snapshot demotes the older entry and a hit promotes it."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCache, PrefixCacheConfig
    from repro_torch.serving import prefix_cache as pcm
    from repro_torch.serving import slots as slot_ops
    cfg = configs.get_config("smollm-135m")
    pool = lm.init_serve_state(cfg, b=2, max_len=64, per_slot=True,
                               device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for t in pool["layers"]:
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    pool["pos"].copy_(torch.tensor([17, 300], device=dev))
    snaps = [slot_ops.read_slots(pool, torch.tensor([i], device=dev))
             for i in range(2)]
    want = [[t.cpu() for t in (*s["layers"], s["pos"])] for s in snaps]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(50_000_000)
        host = pcm.snapshot_to_host(snaps[0])
        back = pcm.snapshot_to_device(host, dev)
        pc = PrefixCache(PrefixCacheConfig(block_tokens=4,
                                           device_bytes=pcm._tree_bytes(
                                               snaps[0])),
                         to_host=pcm.snapshot_to_host,
                         to_device=lambda s: pcm.snapshot_to_device(s, dev))
        pc.put([1] * 4, snaps[0])
        pc.put([2] * 4, snaps[1])                  # demotes [1] * 4
        ent = pc.match([1] * 5)
        promoted = pc.device_state(ent)            # demotes [2] * 4
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pc.stats["prefix_demotions"] == 2
    assert pc.stats["prefix_promotions"] == 1
    host.wait()
    leaves = [(*host.tree["layers"], host.tree["pos"]),
              (*back["layers"], back["pos"]),
              (*promoted["layers"], promoted["pos"])]
    assert all(t.is_pinned() for t in leaves[0])
    for got in leaves:
        for a, b in zip(got, want[0]):
            assert torch.equal(a.cpu(), b)
    ent2 = pc.match([2] * 5)
    assert ent2.on_host
    assert all(torch.equal(a.cpu(), b) for a, b in zip(
        (*pc.device_state(ent2)["layers"],), want[1][:3]))


@pytest.mark.cuda
def test_paged_exact_engine_matches_contiguous(dev):
    """An exact smollm-135m at full width over paged KV (pages of 16,
    max_len 512, a multiple of them, so the gathered view has the
    cache's length): every request forks the primed prefix, sharing its
    pages, and the greedy streams equal the contiguous exact engine's at
    one staged row per prefill call; the overlapped steps make no
    synchronising call, and no kernel launches."""
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCacheConfig, ServingEngine
    cfg = _exact_cfg(use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    primer, reqs = _shared_prefix_traffic(cfg.vocab)
    before = (kd.launches, kp.launches, kds.launches)
    streams = []
    for cache in (None, PrefixCacheConfig()):
        eng = ServingEngine(params, cfg, max_slots=4, max_len=512,
                            chunk_tokens=64, prefill_rows=1, overlap=True,
                            prefix_cache=cache, device=dev)
        got, pre, _ = _primed_run(eng, primer, reqs, sync_error=True)
        streams.append(got)
        st = eng.stats
        assert st["decode_path"] == ("exact_paged" if cache else "exact")
        if cache is not None:
            assert st["forked_requests"] - pre["forked_requests"] == 6
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]
    assert (kd.launches, kp.launches, kds.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["darkformer", "exact"])
def test_decode_row_does_not_depend_on_the_batch(dev, kind):
    """The numerical contract a fork's parity rests on: at full width, a
    decode step over 8 prefilled rows gives each row the logits it gets
    decoded alone. Bitwise for darkformer (B1 computes each row on its
    own). For exact, within two bf16 ulps of the row's largest logit
    (|gap| <= 2^-6 max|logit|): the engine needs equal greedy tokens,
    which no tolerance guarantees at a tie, so phase 3e of chip_smoke.py
    holds the streams themselves."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import slots as slot_ops
    cfg = configs.get_config("smollm-135m", use_kernel=True)
    if kind == "exact":
        cfg = configs.darkify(cfg, "exact")
    params = lm.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (8, 64), generator=gen).to(dev)
    st = lm.init_serve_state(cfg, b=8, max_len=1024, per_slot=True,
                             device=dev)
    lm.prefill_chunk(params, cfg, {"tokens": toks}, st)
    nxt = torch.randint(0, cfg.vocab, (8,), generator=gen).to(dev)

    def step(rows):
        idx = torch.tensor(rows, device=dev)
        logits, _ = lm.decode_step(params, cfg, nxt[idx],
                                   slot_ops.read_slots(st, idx))
        return logits
    full = step(list(range(8)))
    for i in range(8):
        alone = step([i])[0]
        if kind == "darkformer":
            assert torch.equal(alone, full[i]), i
        else:
            gap = (alone.float() - full[i].float()).abs().max()
            assert gap <= 2 ** -6 * full[i].float().abs().max(), (i, gap)


def _calibration_case():
    """The reduced f32 smollm-135m (seed 0) and a 4 x 32 SyntheticLM batch
    on the CPU."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    cfg = configs.get_config("smollm-135m", reduced=True)
    params = lm.init_params(cfg, seed=0, device="cpu")
    data = SyntheticLM(cfg.vocab, 32, 4, seed=0).batch(0)
    return cfg, params, {k: torch.from_numpy(v).long()
                         for k, v in data.items()}


@pytest.mark.cuda
def test_whitening_calibration_matches_cpu(dev):
    """``lm.whitening_calibrate`` on the card (through B5) against the
    port's CPU run from the same params and batch: each (layer, group)'s
    Sigma = M^T M within 1e-3 of its max |Sigma| (M's rows are fixed by
    eigh only up to sign), and on the card M Lambda M^T = I within 1e-3,
    Lambda in f64 from the card's taps; the input params untouched."""
    import dataclasses
    from repro_torch.models import lm
    cfg, params, batch = _calibration_case()
    kcfg = dataclasses.replace(cfg, use_kernel=True)
    card_params = lm.tree_map(lambda t: t.to(dev), params)
    card_batch = {k: t.to(dev) for k, t in batch.items()}
    m_cpu = lm.whitening_calibrate(params, cfg, batch)[
        "units"]["b0"]["attn"]["feat"]["m_mat"].double()
    m_card = lm.whitening_calibrate(card_params, kcfg, card_batch)[
        "units"]["b0"]["attn"]["feat"]["m_mat"].double()
    assert torch.equal(card_params["units"]["b0"]["attn"]["feat"]["m_mat"],
                       params["units"]["b0"]["attn"]["feat"]["m_mat"].to(dev))
    s_cpu = torch.einsum("lgrd,lgre->lgde", m_cpu, m_cpu)
    s_card = torch.einsum("lgrd,lgre->lgde", m_card, m_card).cpu()
    for li in range(cfg.n_layers):
        for gi in range(cfg.n_kv):
            gap = (s_card[li, gi] - s_cpu[li, gi]).abs().max()
            assert gap <= 1e-3 * s_cpu[li, gi].abs().max(), (li, gi, gap)
    taps = lm.collect_qk(card_params, kcfg, card_batch)
    scale = cfg.head_dim ** -0.25
    d = cfg.head_dim
    for li in range(cfg.n_layers):
        q, k = taps[f"unit{li}/b0"]
        for gi in range(cfg.n_kv):
            x = torch.cat([(q[:, gi].double() * scale).reshape(-1, d),
                           (k[:, gi].double() * scale).reshape(-1, d)])
            x = x - x.mean(0)
            cov = x.T @ x / x.shape[0]
            lam = 0.95 * cov + 0.05 * torch.trace(cov) / d * torch.eye(
                d, dtype=torch.float64, device=dev)
            m = m_card[li, gi]
            white = m @ lam @ m.T
            eye = torch.eye(d, dtype=torch.float64, device=dev)
            assert float((white - eye).abs().max()) <= 1e-3, (li, gi)


@pytest.mark.cuda
def test_calibration_covariance_ignores_tf32_setting(dev):
    """With TF32 on for the process, the calibration's covariance (f64
    accumulation, rounded to f32) is the CPU's within 1e-6 of max
    |Lambda| (TF32's 10-bit mantissa would part by ~1e-3), and the
    setting is left as it was."""
    from repro_torch.core import calibration as cal
    x = torch.randn(4096, 64, generator=torch.Generator().manual_seed(2))
    x = x * torch.linspace(0.1, 3.0, 64)
    ref = cal.shrinkage_covariance(x)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = cal.shrinkage_covariance(x.to(dev)).cpu()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.cuda
def test_collect_qk_launches_the_scan_once_a_layer(dev):
    """``lm.collect_qk`` under ``use_kernel`` on the card: B5 launched once
    a layer and no other kernel; every tap within 1e-4 of the CPU's."""
    import dataclasses
    from repro_torch.models import lm
    cfg, params, batch = _calibration_case()
    kcfg = dataclasses.replace(cfg, use_kernel=True)
    counters = (kl, "launches"), (kl, "carry_launches"), (kd, "launches"), \
        (kp, "launches"), (kds, "launches"), (kf, "launches"), \
        (kw, "launches")
    for mod, attr in counters:
        setattr(mod, attr, 0)
    taps = lm.collect_qk(lm.tree_map(lambda t: t.to(dev), params), kcfg,
                         {k: t.to(dev) for k, t in batch.items()})
    counts = [getattr(mod, attr) for mod, attr in counters]
    assert counts == [cfg.n_layers, 0, 0, 0, 0, 0, 0], counts
    ref = lm.collect_qk(params, cfg, batch)
    assert list(taps) == list(ref)
    for name in ref:
        for a, b in zip(taps[name], ref[name]):
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_expected_variance_draws_the_same_pairs_on_both_devices(dev):
    """One seed, the same (q, k) pairs on the card and on the CPU: the
    expected variances within 1e-4 relative (the pairs drawn on the CPU
    and moved; f32 sums in another order)."""
    from repro_torch.core import variance as vr
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(8, 8, generator=gen)
    q, _ = torch.linalg.qr(a)
    lam = (q * torch.linspace(0.05, 0.4, 8)) @ q.T
    star = vr.optimal_sigma_star(lam)
    for sigma in (None, star):
        cpu = vr.expected_variance(torch.Generator().manual_seed(9), lam,
                                   sigma)
        card = vr.expected_variance(
            torch.Generator().manual_seed(9), lam.to(dev),
            None if sigma is None else sigma.to(dev))
        assert card.device.type == "cuda"
        assert abs(float(card) - float(cpu)) <= 1e-4 * abs(float(cpu))


# moe_apply, card against CPU: a token's routing may differ only where its
# k-th and (k+1)-th router probabilities lie within MOE_NEAR_TIE (f32
# logits in other summation orders differ by ~1e-7 of a logit); the
# combined bf16 output within MOE_BF16_TOL of its largest magnitude (the
# experts' bf16 products and the combine round on each device)
MOE_NEAR_TIE = 1e-6
MOE_BF16_TOL = 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(8, 32), (1, 256), (8, 1)])
def test_moe_apply_matches_cpu(dev, b, l):
    """granite-moe-3b-a800m's MoE widths (d 1536, 40 experts, top-8,
    d_ff 512, bf16 experts, f32 router) at the packer's 8 x 32 and 1 x 256
    grants and at a decode step: in every capacity group (batch row)
    without a near-tie at the top-k boundary, the experts each token picks
    and each pair's capacity position and kept flag are the CPU's, the
    output is within MOE_BF16_TOL of the CPU's, and the aux loss agrees."""
    from repro_torch.models import layers as ll
    cfg = ll.MoEConfig(num_experts=40, top_k=8, d_ff=512)
    gen = torch.Generator().manual_seed(b * 1000 + l)
    params = ll.moe_init(gen, 1536, cfg, torch.bfloat16)
    x = torch.randn((b, l, 1536), generator=gen).to(torch.bfloat16)
    card = {n: t.to(dev) for n, t in params.items()}
    with torch.no_grad():
        got, got_aux = ll.moe_apply(card, x.to(dev), cfg)
        exp, exp_aux = ll.moe_apply(params, x, cfg)
        r_card = ll.moe_route(x.to(dev), card["router"], cfg)
        r_cpu = ll.moe_route(x, params["router"], cfg)
    top = r_cpu[0].topk(cfg.top_k + 1, dim=-1).values
    tied = ((top[..., -2] - top[..., -1]) < MOE_NEAR_TIE).any(-1)    # (B,)
    rows = (~tied).nonzero()[:, 0]
    assert len(rows) >= (b + 1) // 2, f"near-ties in {int(tied.sum())} rows"
    # a token's pairs take distinct experts, so their order within the
    # token moves no capacity position: compare in expert order
    def in_expert_order(route):
        idx = route[2].cpu()
        order = idx.argsort(-1)
        return [t.cpu().gather(-1, order)[rows] for t in route[2:5]]
    for what, g, e in zip(("idx", "pos", "in_cap"), in_expert_order(r_card),
                          in_expert_order(r_cpu)):
        assert torch.equal(g, e), what
    assert r_card[5] == r_cpu[5]
    err = (got.float().cpu()[rows] - exp.float()[rows]).abs().max()
    assert float(err) <= MOE_BF16_TOL * float(exp.float().abs().max()), err
    assert abs(float(got_aux) - float(exp_aux)) <= 1e-5 * float(exp_aux)


@pytest.mark.cuda
def test_moe_engine_makes_no_sync_and_matches_sequential(dev):
    """The reduced granite-moe-3b-a800m on the card through B1/B2: the
    overlapped engine's steps make no synchronising call (the MoE
    routing, scatter and gather included) and, at one staged row per
    prefill call, its greedy streams equal the sequential engine's."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, synthetic_requests
    cfg = configs.get_config("granite-moe-3b-a800m", reduced=True,
                             use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=4, max_len=256,
                            chunk_tokens=32, prefill_rows=1, overlap=overlap,
                            device=dev)
        reqs = synthetic_requests(6, cfg.vocab, seed=2,
                                  prompt_range=(8, 80), gen_range=(8, 16))
        uids = [eng.submit(r) for r in reqs]
        n1, n2 = kd.launches, kp.launches
        if overlap:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = {r.uid: r.tokens for r in eng.run()}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        streams.append([got[u] for u in uids])
        st = eng.stats
        assert st["decode_path"] == st["prefill_path"] == "fused_kernel"
        assert kd.launches - n1 == st["decode_steps"] * cfg.n_layers
        assert kp.launches - n2 == st["prefill_calls"] * cfg.n_layers
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m"])
def test_init_params_draws_on_the_card(dev, arch):
    """``init_params(draw_on=card)``: the CPU-drawn tree's leaves, shapes
    and dtypes, on the card; the same numbers for the same seed and
    other numbers for another; the embedding within its two standard
    deviations; the identity ``m_mat`` and norms as drawn on the CPU."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    cfg = configs.get_config(arch, reduced=True)
    cpu = dict(flatten(lm.init_params(cfg, seed=0, device="cpu")))
    tree = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
    got = dict(flatten(tree))
    again = dict(flatten(lm.init_params(cfg, seed=0, device=dev,
                                        draw_on=dev)))
    other = dict(flatten(lm.init_params(cfg, seed=1, device=dev,
                                        draw_on=dev)))
    assert got.keys() == cpu.keys()
    for name, t in got.items():
        assert t.device.type == "cuda", name
        assert (t.shape, t.dtype) == (cpu[name].shape, cpu[name].dtype), name
        assert torch.equal(t, again[name]), name
        if "m_mat" in name or "norm" in name or "ln" in name:
            assert torch.equal(t.cpu(), cpu[name]), name
        else:
            assert not torch.equal(t, other[name]), name
            assert torch.isfinite(t.float()).all(), name
    embed = tree["embed"].float()
    assert float(embed.abs().max()) <= 2 * cfg.vocab ** -0.5 * 1.01


# the RG-LRU card against CPU: f32 through cuBLAS and CUDA's exp in
# another order (no TF32), bf16 after one bf16 rounding of the products
# u @ wx, u @ wg and of the output; the largest gap over the largest
# value of each tensor
RGLRU_F32_TOL = 1e-4
RGLRU_BF16_TOL = 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ragged", [False, True])
def test_rglru_apply_matches_cpu(dev, dtype, ragged):
    """``rglru_apply`` at recurrentgemma-2b's width (d_model = d_rnn =
    2560) from a carried state, a packer's 4 x 64 chunk, ragged or full,
    then one decode step: outputs, h and the conv tail on the card within
    their tolerance of the CPU's. It runs no kernel (the reference's
    block is plain ``jnp``); under ``set_sync_debug_mode("error")`` it
    makes no synchronising call."""
    from repro_torch.models import recurrent as rec
    gen = torch.Generator().manual_seed(11)
    params = rec.rglru_init(gen, 2560, 2560, dtype)
    u = torch.randn((4, 64, 2560), generator=gen).to(dtype)
    st = rec.RGLRUState(h=torch.randn((4, 2560), generator=gen),
                        conv=torch.randn((4, 3, 2560), generator=gen).to(
                            dtype).float())
    vl = (torch.tensor([64, 17, 1, 40], dtype=torch.int32) if ragged
          else None)
    tol = RGLRU_F32_TOL if dtype == torch.float32 else RGLRU_BF16_TOL
    card = {n: t.to(dev) for n, t in params.items()}

    def run(p, x, s, v, x1):
        out, s = rec.rglru_apply(p, x, s, v)
        out1, s1 = rec.rglru_decode(p, x1, s)
        return out, s, out1, s1
    args = (u.to(dev), rec.RGLRUState(*(t.to(dev) for t in st)),
            None if vl is None else vl.to(dev), u[:, :1].to(dev))
    torch.cuda.synchronize()
    with torch.no_grad():
        exp = run(params, u, st, vl, u[:, :1])
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(card, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    mask = (torch.ones(4, 64, dtype=torch.bool) if vl is None else
            torch.arange(64)[None] < vl[:, None])
    pairs = [(got[0].cpu()[mask], exp[0][mask]), (got[2].cpu(), exp[2]),
             *((g.cpu(), e) for g, e in zip(got[1], exp[1])),
             *((g.cpu(), e) for g, e in zip(got[3], exp[3]))]
    for g, e in pairs:
        assert g.dtype == e.dtype
        err = float((g.float() - e.float()).abs().max())
        assert err <= tol * float(e.float().abs().max()), err


@pytest.mark.cuda
def test_recurrentgemma_engine_makes_no_sync_and_matches_sequential(dev):
    """The reduced recurrentgemma-2b (unit/rem layout, RG-LRU and a local
    layer) on the card through B1/B2: the overlapped engine's steps make
    no synchronising call and, at one staged row per prefill call, its
    greedy streams equal the sequential engine's; B1/B2 launch once an
    attention layer a step and a call."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, synthetic_requests
    cfg = configs.get_config("recurrentgemma-2b", reduced=True,
                             use_kernel=True)
    n_attn = sum(k != "rec" for k in cfg.layer_kinds())
    params = lm.init_params(cfg, seed=0, device=dev)
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=4, max_len=256,
                            chunk_tokens=32, prefill_rows=1, overlap=overlap,
                            device=dev)
        reqs = synthetic_requests(6, cfg.vocab, seed=2,
                                  prompt_range=(8, 80), gen_range=(8, 16))
        uids = [eng.submit(r) for r in reqs]
        n1, n2 = kd.launches, kp.launches
        if overlap:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = {r.uid: r.tokens for r in eng.run()}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        streams.append([got[u] for u in uids])
        st = eng.stats
        assert st["decode_path"] == st["prefill_path"] == "fused_kernel"
        assert kd.launches - n1 == st["decode_steps"] * n_attn
        assert kp.launches - n2 == st["prefill_calls"] * n_attn
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]


# rwkv6_apply and rwkv6_channel_mix card vs CPU at rwkv6-7b's width: the
# largest gap over the largest value of each tensor. The scan runs in f32
# (einsum through cuBLAS on the card), so f32 inputs agree to f32
# rounding carried through the LayerNorm; bf16 inputs also round the
# projections (u @ wr, ...) in other orders, an ulp here and there
RWKV_F32_TOL = 1e-4
RWKV_BF16_TOL = 0.02


def _launch_counts():
    return (kd.launches, kp.launches, kds.launches, kl.launches,
            kl.carry_launches, kf.launches, kw.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ragged", [False, True])
def test_rwkv6_apply_matches_cpu(dev, dtype, ragged):
    """RWKV-6's time and channel mixes at rwkv6-7b's width (d_model 4096,
    64 heads of 64, d_ff 14 336) from a carried state, a 4 x 32 chunk,
    ragged or full, then one decode step: outputs, S and both shifts on
    the card within their tolerance of the CPU's. No kernel launches
    (the reference's block runs its own scan, not wkv6), and under
    ``set_sync_debug_mode("error")`` nothing synchronises."""
    from repro_torch.models import recurrent as rec
    gen = torch.Generator().manual_seed(12)
    d, h, f = 4096, 64, 14_336
    tmix = rec.rwkv6_init(gen, d, h, dtype=dtype)
    tmix["u"] = 0.5 * torch.randn((h, d // h), generator=gen)
    tmix["lam_w"] = torch.rand((d,), generator=gen) - 0.5
    cmix = rec.rwkv6_channel_mix_init(gen, d, f, dtype)
    x = torch.randn((4, 32, d), generator=gen).to(dtype)
    st = rec.RWKVState(s=0.5 * torch.randn((4, h, d // h, d // h),
                                           generator=gen),
                       shift=torch.randn((4, d), generator=gen).to(
                           dtype).float())
    csh = torch.randn((4, d), generator=gen).to(dtype).float()
    vl = (torch.tensor([32, 9, 1, 20], dtype=torch.int32) if ragged
          else None)
    tol = RWKV_F32_TOL if dtype == torch.float32 else RWKV_BF16_TOL

    def run(tp, cp, x, s, c, v):
        out, s = rec.rwkv6_apply(tp, x, h, s, v)
        cout, c = rec.rwkv6_channel_mix(cp, x, c, v)
        out1, s1 = rec.rwkv6_apply(tp, x[:, :1], h, s)
        cout1, c1 = rec.rwkv6_channel_mix(cp, x[:, :1], c)
        return out, cout, out1, cout1, *s, c, *s1, c1
    card = [{n: (t.to(dev) if torch.is_tensor(t) else
                 {k: u.to(dev) for k, u in t.items()})
             for n, t in p.items()} for p in (tmix, cmix)]
    args = (x.to(dev), rec.RWKVState(*(t.to(dev) for t in st)),
            csh.to(dev), None if vl is None else vl.to(dev))
    torch.cuda.synchronize()
    before = _launch_counts()
    with torch.no_grad():
        exp = run(tmix, cmix, x, st, csh, vl)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(*card, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert _launch_counts() == before
    mask = (torch.ones(4, 32, dtype=torch.bool) if vl is None else
            torch.arange(32)[None] < vl[:, None])
    for i, (g, e) in enumerate(zip(got, exp)):
        g = g.cpu()
        assert g.dtype == e.dtype, i
        if i in (0, 1):
            g, e = g[mask], e[mask]
        err = float((g.float() - e.float()).abs().max())
        assert err <= tol * float(e.float().abs().max()), (i, err)


@pytest.mark.cuda
def test_rwkv_engine_makes_no_sync_and_matches_sequential(dev):
    """The reduced rwkv6-7b (layer-stacked, no attention layer) on the
    card: the overlapped engine's steps make no synchronising call, its
    paths read ``none`` and none of the seven kernels launches whatever
    ``use_kernel`` says; at one staged row per prefill call its greedy
    streams equal the sequential engine's."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, synthetic_requests
    cfg = configs.get_config("rwkv6-7b", reduced=True, use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=4, max_len=256,
                            chunk_tokens=32, prefill_rows=1, overlap=overlap,
                            device=dev)
        reqs = synthetic_requests(6, cfg.vocab, seed=2,
                                  prompt_range=(8, 80), gen_range=(8, 16))
        uids = [eng.submit(r) for r in reqs]
        before = _launch_counts()
        if overlap:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = {r.uid: r.tokens for r in eng.run()}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        streams.append([got[u] for u in uids])
        st = eng.stats
        assert st["decode_path"] == st["prefill_path"] == "none"
        assert _launch_counts() == before
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[1]] == [r.max_new_tokens for r in reqs]


# the noncausal PRF attention, card (cuBLAS) against CPU, f32 and bf16:
# the largest output gap over the largest |output|
NONCAUSAL_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.02}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_prf_attention_matches_cpu(dev, dtype):
    """hubert-xlarge's attention: ``rf_attention(causal=False)`` (the
    reference's two-matmul form, plain PyTorch) at its heads (16 groups
    of one head, d_head 80, m 256) over 2 x 512 frames, on the card
    within NONCAUSAL_TOL of the CPU's, launching no kernel even under
    ``use_kernel``."""
    from repro_torch.core import attention as rfa
    from repro_torch.core import feature_maps as fm
    cfg = fm.FeatureConfig(kind="darkformer", num_features=256,
                           orthogonal=True)
    gen = torch.Generator().manual_seed(5)
    fp = fm.init_feature_params(gen, cfg, 80, n_groups=16)
    fp["m_mat"] += 0.1 * 80 ** -0.5 * torch.randn(fp["m_mat"].shape,
                                                  generator=gen)
    q = (torch.randn((2, 16, 1, 512, 80), generator=gen) * 80 ** -0.25)
    k = (torch.randn((2, 16, 1, 512, 80), generator=gen) * 80 ** -0.25)
    v = torch.randn((2, 16, 1, 512, 80), generator=gen)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = _launch_counts()
    with torch.no_grad():
        exp = rfa.rf_attention(q, k, v, fp, cfg, causal=False,
                               use_kernel=True)
        got = rfa.rf_attention(q.to(dev), k.to(dev), v.to(dev),
                               {n: t.to(dev) for n, t in fp.items()}, cfg,
                               causal=False, use_kernel=True)
    assert _launch_counts() == before
    assert got.dtype == exp.dtype == dtype and got.shape == exp.shape
    err = float((got.cpu().float() - exp.float()).abs().max())
    assert err <= NONCAUSAL_TOL[dtype] * float(exp.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-76b"])
def test_embed_inputs_match_cpu(dev, arch):
    """``lm._embed_inputs`` of the modality at full width, bf16: audio
    frames with ``mask_embed`` at the masked frames, or 256 patches
    before the text tokens; the card's bitwise the CPU's (a cast, a
    select, a gather and a concatenation)."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import lm
    cfg = configs.get_config(arch, n_layers=1)
    gen = torch.Generator().manual_seed(3)
    params = {"embed": torch.randn((cfg.vocab, cfg.d_model),
                                   generator=gen).to(torch.bfloat16)}
    if cfg.modality == "audio":
        params["mask_embed"] = torch.randn(
            (cfg.d_model,), generator=gen).to(torch.bfloat16)
    args = type("Args", (), dict(seq=64, batch=2, seed=0,
                                 data="synthetic"))()
    batch = train.make_data(cfg, args).batch(0)
    exp = lm._embed_inputs(params, cfg, train.to_device(batch, "cpu"))
    got = lm._embed_inputs({n: t.to(dev) for n, t in params.items()}, cfg,
                           train.to_device(batch, dev))
    length = 64 + (cfg.num_patches if cfg.modality == "vlm" else 0)
    assert exp.shape == (2, length, cfg.d_model)
    assert exp.dtype == got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), exp)
    if cfg.modality == "audio":
        mask = torch.from_numpy(batch["mask"])
        assert mask.any() and torch.equal(
            exp[mask], params["mask_embed"].expand(int(mask.sum()), -1))
