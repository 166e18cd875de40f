"""Card-only tests of the port's CUDA kernels against their plain version.

They need an NVIDIA GPU and skip elsewhere (the reason names the missing
device).  This file imports no JAX, so it runs on a machine with only
the port's dependencies:

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
      tests/test_torch_cuda.py

Integer outputs are compared with torch.equal: the kernels (the real
and complex macro GEMMs, prepacked and unpacked) and their plain
versions compute the same integers, so there is no tolerance.  So are
the W8A8 kernel's float32 outputs: its integer dot is exact and its
epilogue the plain version's two float32 roundings.  The
paged-attention kernel computes P.V in float32 where the plain version
rounds p to bf16 first; it is held to the tolerance written beside it.
The serving drivers' captured graphs (``launch/graphs.py``) are held to
their eager runs with ``==`` on tokens and logits, and on launch counts,
sampled and noisy serving included; the card's threefry draws and noisy
GEMM ints to the CPU port's with ``==``.  Rows 1 and 2 count the clipped
ADC conversions as their plain version does, with ``==``, and the
telemetry rings a captured step writes equal the eager step's.

Training: a QAT step through row 6 equals the step through its plain
version with ``==`` under ``torch.use_deterministic_algorithms(True)``,
which needs cuBLAS's restricted workspace (``CUBLAS_WORKSPACE_CONFIG``
``:4096:8``, set below before the first cuBLAS call).  It applies to the
whole process, so every test of this module runs under it.  The card's
own training branches (the flash backward's exp, the CE's logsumexp, the
STE's bf16 cuBLAS products, AdamW's sqrt and norm) are held to the CPU
path, which ``tests/test_torch_train.py`` holds to the reference, at the
tolerances written beside them.
"""
import dataclasses
import os

import pytest

# deterministic cuBLAS (the training tests' torch.use_deterministic_
# algorithms) needs this before the process's first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch.core import ccim, engine  # noqa: E402
from repro_torch.core.ccim import CCIMConfig  # noqa: E402
from repro_torch.kernels.ccim_complex import kernel as CK  # noqa: E402
from repro_torch.kernels.ccim_complex import ops as CO  # noqa: E402
from repro_torch.kernels.ccim_matmul import kernel as K  # noqa: E402
from repro_torch.kernels.ccim_matmul import ops as KO  # noqa: E402
from repro_torch.kernels.int8_matmul import kernel as IK  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as IO  # noqa: E402
from repro_torch.kernels.paged_attn import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_attn import ref as PR  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _ints(gen, shape, dev):
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("acc_len", [8, 16, 32, 64])
@pytest.mark.parametrize("n_dcim", [0, 3, 6])
@pytest.mark.parametrize("m", [1, 5, 32, 33, 100])
def test_kernel_equals_plain(dev, acc_len, n_dcim, m):
    gen = torch.Generator(device=dev)
    gen.manual_seed(acc_len * 100 + n_dcim * 10 + m)
    cfg = CCIMConfig(n_dcim_products=n_dcim, acc_len=acc_len, adc_bits=8)
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (520, 70), dev), torch.ones((1, 70), device=dev), cfg)
    x = _ints(gen, (m, 520), dev)
    y_k = engine.packed_cim_matmul_int(x, p, cfg=cfg)
    y_p = engine.packed_cim_matmul_int(x, p, cfg=cfg, use_kernel=False)
    assert torch.equal(y_k, y_p)


def _ragged_split_k(m: int, n: int, acc_len: int) -> int:
    """The least K from 990 whose padded K the general kernel cuts, on this
    card, into several splits with a shorter last one."""
    for k in range(990, 20000, 16):
        kp = KO.weight_layout(k, n, acc_len)[0]
        ks = K.general_k_split(m, n, kp, acc_len)
        assert ks > 0 and ks % 64 == 0
        if ks < kp and kp % ks:
            return k
    raise AssertionError(f"no ragged split for M {m}, N {n}, acc {acc_len}")


@pytest.mark.parametrize("acc_len", [8, 16, 32, 64])
@pytest.mark.parametrize("n_planes", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [33, 77, 128, 129, 512])
def test_general_kernel_equals_plain(dev, acc_len, n_planes, m):
    """The general (tensor-core) kernel against its plain version at
    ragged N (70, 300), at K 1000 and at a K that the kernel's own split
    of K leaves a shorter last split (the chunk count is then not a
    multiple of the split count); one launch per call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(acc_len * 1000 + n_planes * 100 + m)
    x_bits = (6, 5, 4)[:n_planes]
    meta = dict(acc_len=acc_len, x_bits=x_bits, dcim_lsb=64 * acc_len,
                adc_half=64)
    i8 = lambda lo, hi, *shape: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)
    for n in (70, 300):
        for k in (1000, _ragged_split_k(m, n, acc_len)):
            kp = KO.weight_layout(k, n, acc_len)[0]
            x, w = i8(-127, 128, m, kp), i8(-127, 128, n, kp)
            planes = i8(-7, 8, n_planes, n, kp)
            want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
            K.reset_launch_counts()
            got = K.ccim_matmul_prepacked_general_cuda(x, w, planes, **meta)
            torch.cuda.synchronize()
            assert K.ccim_matmul_prepacked_general_cuda.launches == 1
            assert got.dtype == torch.int32 and torch.equal(got, want), (
                n, k, K.general_k_split(m, n, kp, acc_len))


# minicpm-2b's four full-width layer GEMMs, (K, N)
FULL_SHAPES = ((2304, 9216), (3072, 2304), (2304, 11520), (5760, 2304))
# mamba2-130m's two: the fused input group w_z+w_x+w_bc+w_dt (N 1,536 +
# 1,536 + 256 + 24, ragged: 16 x 209 + 8) and out_proj
MAMBA_SHAPES = ((768, 3352), (1536, 768))
# zamba2-1.2b's six: the Mamba2 fused input group (N 4,096 + 4,096 + 128
# + 64), out_proj, and the shared block's QKV, wo, w1+w3 and w2
ZAMBA_SHAPES = ((2048, 8384), (4096, 2048), (2048, 6144), (2048, 2048),
                (2048, 16384), (8192, 2048))


def _skinny_case(dev, gen, m, k, n, acc_len, n_planes, packed):
    """x, w, planes and meta of one skinny case: a prototype pack of
    random ints (``packed``) or random w with planes in [-7, 7] drawn
    independently of w, at a non-prototype split."""
    i8 = lambda lo, hi, *shape: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)
    if packed:
        p = engine.pack_quantized_cim_weights(
            _ints(gen, (k, n), dev), torch.ones((1, n), device=dev))
        w, planes = p.kernel_w, p.kernel_planes
        meta = dict(acc_len=16, x_bits=(6, 5), dcim_lsb=2048, adc_half=64)
    else:
        kp = KO.weight_layout(k, n, acc_len)[0]
        w, planes = i8(-127, 128, n, kp), i8(-7, 8, n_planes, n, kp)
        meta = dict(acc_len=acc_len, x_bits=(6, 5, 4)[:n_planes],
                    dcim_lsb=32 * acc_len, adc_half=32)
    return i8(-127, 128, m, w.shape[1]), w, planes, meta


@pytest.mark.parametrize(
    "m,k,n,acc_len,n_planes",
    [(m, k, n, 16, 2) for k, n in FULL_SHAPES + MAMBA_SHAPES
     for m in (1, 2, 4, 8, 16, 17, 31, 32)]
    + [(3, 1008, 37, 16, 2), (4, 64, 33792, 16, 2)]
    + [(m, 1000, 300, acc, np_) for m in (4, 32) for acc in (8, 16, 32, 64)
       for np_ in range(4)])
def test_skinny_kernel_equals_plain(dev, m, k, n, acc_len, n_planes):
    """Kernel row 1 against its plain version: the four full-width layer
    GEMMs of minicpm-2b's and mamba2-130m's two (the SSM's decode steps
    at M 1-8, its paged prefill chunks at M 32) of a prototype pack at M
    1-32 (wo and w2 cut every column group
    between blocks: split < Kp), a ragged one (M 3, K 1008, N 37), one
    where each block walks whole one-stage groups (K 64, N 33,792:
    no group is cut, plain stores), and 0-3 planes in [-7, 7] x acc_len
    8-64 at M 4 and 32 (dcim_lsb 32 acc_len, adc_half 32: codes clip).
    ints compared with torch.equal; one launch per call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 7 + k + n + acc_len + n_planes)
    x, w, planes, meta = _skinny_case(dev, gen, m, k, n, acc_len, n_planes,
                                      packed=(k, n) != (1000, 300))
    kp = w.shape[1]
    split = K.skinny_k_split(m, n, kp, meta["acc_len"])
    assert split > 0 and split % 64 == 0
    if (k, n) in ((3072, 2304), (5760, 2304)):
        assert split < kp
    if (k, n) == (64, 33792):
        assert split >= kp
    K.reset_launch_counts()
    got = K.ccim_matmul_prepacked_skinny_cuda(x, w, planes, **meta)
    torch.cuda.synchronize()
    assert K.ccim_matmul_prepacked_skinny_cuda.launches == 1
    want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
    assert got.dtype == torch.int32 and torch.equal(got, want), split


@pytest.mark.parametrize("m", [33, 128, 512])
@pytest.mark.parametrize("k,n", MAMBA_SHAPES)
def test_general_kernel_mamba_shapes_equal_plain(dev, m, k, n):
    """Kernel row 2 on a prototype pack at mamba2-130m's two GEMMs (K 768
    has not met the kernel's K split elsewhere): M 128 is a one-chunk
    prefill row block, M 512 the lock-step prefill of batch 4; ints
    compared with torch.equal; one launch per call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x, w, planes, meta = _skinny_case(dev, gen, m, k, n, 16, 2, packed=True)
    K.reset_launch_counts()
    got = K.ccim_matmul_prepacked_general_cuda(x, w, planes, **meta)
    torch.cuda.synchronize()
    assert K.ccim_matmul_prepacked_general_cuda.launches == 1
    want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
    assert got.dtype == torch.int32 and torch.equal(got, want), (
        K.general_k_split(m, n, w.shape[1], 16))


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n", ZAMBA_SHAPES)
def test_zamba_shapes_rows_1_2_6_equal_plain(dev, m, k, n):
    """zamba2-1.2b's six GEMMs on a prototype pack: kernel row 1 at M 4
    (decode) or row 2 at M 128 (a one-chunk admit), and row 6 on the raw
    ints at the same M; ints compared with torch.equal, one launch each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x, w, planes, meta = _skinny_case(dev, gen, m, k, n, 16, 2, packed=True)
    row = (K.ccim_matmul_prepacked_skinny_cuda if m <= K.SKINNY_M
           else K.ccim_matmul_prepacked_general_cuda)
    K.reset_launch_counts()
    got = row(x, w, planes, **meta)
    torch.cuda.synchronize()
    assert row.launches == 1
    want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    xi, wi = _ints(gen, (m, k), dev), _ints(gen, (k, n), dev)
    got = KO.ccim_matmul_int(xi, wi)
    torch.cuda.synchronize()
    assert K.ccim_matmul_unpacked_cuda.launches == 1
    assert torch.equal(got, KO.ccim_matmul_int(xi, wi, use_kernel=False))


# qwen3-14b's, starcoder2-7b's and gemma2-9b's four full-width layer
# GEMMs (K, N): the fused QKV (heads padded to 48 for the first two),
# wo, w1+w3 and w2
DENSE_SHAPES = ((5120, 8192), (6144, 5120), (5120, 34816), (17408, 5120),
                (4608, 7168), (6144, 4608), (4608, 36864), (18432, 4608),
                (3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584))


@pytest.mark.parametrize("m", [4, 32, 128])
@pytest.mark.parametrize("k,n", DENSE_SHAPES)
def test_dense_config_shapes_rows_1_2_equal_plain(dev, m, k, n):
    """The three dense configs' GEMMs on a prototype pack, the widest the
    kernels have met (w1+w3 at N 28,672-36,864): row 1 at M 4 (decode)
    and 32 (a paged chunk), row 2 at M 128 (prefill); ints compared with
    torch.equal, one launch each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x, w, planes, meta = _skinny_case(dev, gen, m, k, n, 16, 2, packed=True)
    row = (K.ccim_matmul_prepacked_skinny_cuda if m <= K.SKINNY_M
           else K.ccim_matmul_prepacked_general_cuda)
    K.reset_launch_counts()
    got = row(x, w, planes, **meta)
    torch.cuda.synchronize()
    assert row.launches == 1
    want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
    assert got.dtype == torch.int32 and torch.equal(got, want)


# paligemma-3b's and musicgen-medium's four full-width layer GEMMs (K,
# N): the fused QKV (paligemma: 8 query heads padded to 16 of 256 over
# one kv head; musicgen: 24 MHA heads padded to 32 of 64), wo, w1+w3 and
# w2 (paligemma's at K 16,384)
VLM_AUDIO_SHAPES = ((2048, 4608), (4096, 2048), (2048, 32768),
                    (16384, 2048), (1536, 6144), (2048, 1536),
                    (1536, 12288), (6144, 1536))


@pytest.mark.parametrize("m", [4, 32, 128, 1152])
@pytest.mark.parametrize("k,n", VLM_AUDIO_SHAPES)
def test_vlm_audio_shapes_rows_1_2_6_equal_plain(dev, m, k, n):
    """The vlm and audio configs' GEMMs on a prototype pack: row 1 at M 4
    (decode) and 32 (a paged chunk), row 2 at M 128 (musicgen's prefill)
    and 1,152 (paligemma's: 4 x (256 frontend + 32 prompt) tokens), and
    row 6 on the raw ints at the same M; ints compared with torch.equal,
    one launch each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x, w, planes, meta = _skinny_case(dev, gen, m, k, n, 16, 2, packed=True)
    row = (K.ccim_matmul_prepacked_skinny_cuda if m <= K.SKINNY_M
           else K.ccim_matmul_prepacked_general_cuda)
    K.reset_launch_counts()
    got = row(x, w, planes, **meta)
    torch.cuda.synchronize()
    assert row.launches == 1
    want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    xi, wi = _ints(gen, (m, k), dev), _ints(gen, (k, n), dev)
    K.reset_launch_counts()
    got = KO.ccim_matmul_int(xi, wi)
    torch.cuda.synchronize()
    assert K.ccim_matmul_unpacked_cuda.launches == 1
    assert torch.equal(got, KO.ccim_matmul_int(xi, wi, use_kernel=False))


def test_gemma2_smoke_paged_step_row3_equals_plain(dev, monkeypatch):
    """gemma2-9b's smoke model with its heads widened to Dh 256 (row 3
    does not take the smoke config's 32; G 2, softcap 50, window 64 on
    the local layer 0): one paged decode step after a 72-token paged
    prefill launches row 3 once a layer, and each layer's read, on the
    step's own operands, is within the plain read's tolerance (rtol 2^-7,
    atol 2^-7 max|v|: the kernel's float32 P.V against the plain
    version's p rounded to bf16, as
    test_paged_attention_kernel_matches_plain)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attn import ops as PO
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True),
                              d_head=256)
    params = lm.init(0, cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    B, P, bs = 2, 72, 16
    n_tbl = -(-(P + 1) // bs)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=dev)
    reads, decode = [], PO.paged_attention_decode

    def record(q, k_pool, v_pool, table, lengths, is_local=False, **kw):
        out = decode(q, k_pool, v_pool, table, lengths, is_local, **kw)
        reads.append((out, q, k_pool.clone(), v_pool.clone(), table,
                      lengths, is_local, kw))
        return out
    monkeypatch.setattr(PO, "paged_attention_decode", record)
    with torch.inference_mode():
        cache = lm.init_paged_cache(cfg, B, B * n_tbl + 1, bs, n_tbl,
                                    device=dev)
        cache["table"].copy_(1 + torch.arange(
            B * n_tbl, device=dev, dtype=torch.int32).view(B, n_tbl))
        _, cache = lm.prefill(params, cfg, prompt, cache)
        PK.reset_launch_counts()
        logits, _ = lm.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
    assert PK.paged_attention_cuda.launches == cfg.n_layers == len(reads)
    assert bool(torch.isfinite(logits).all())
    assert [r[6] for r in reads] == [cfg.layer_is_local(i)
                                     for i in range(cfg.n_layers)]
    for out, q, kp, vp, table, lengths, is_local, kw in reads:
        assert kw["softcap"] == 50.0 and kw["window"] == 64
        want = PR.paged_attention_ref(q, kp, vp, table, lengths,
                                      is_local=is_local, **{
                                          k: kw[k] for k in ("softcap",
                                                             "window")})
        torch.testing.assert_close(
            out.float(), want.float(), rtol=2 ** -7,
            atol=2 ** -7 * float(vp.float().abs().max()))


def test_skinny_kernel_repeats_and_alternates(dev):
    """Kernel row 1 zeroes its output itself where its warps add partial
    sums (a tile cut between warps): calls that alternate shapes and M,
    each on a fresh, uninitialized output, all equal the plain version."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = [_skinny_case(dev, gen, m, k, n, 16, 2, packed=True)
             for m, k, n in ((4, 3072, 2304), (3, 1008, 37), (32, 5760, 2304),
                             (1, 3072, 2304), (4, 64, 33792))]
    for x, w, planes, meta in cases * 2:
        got = K.ccim_matmul_prepacked_skinny_cuda(x, w, planes, **meta)
        want = K.ccim_matmul_prepacked_plain(x, w, planes, **meta)
        assert torch.equal(got, want)


def test_dispatch_counts_launches(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = CCIMConfig()
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (64, 48), dev), torch.ones((1, 48), device=dev), cfg)
    K.reset_launch_counts()
    engine.packed_cim_matmul_int(_ints(gen, (4, 64), dev), p, cfg=cfg)
    engine.packed_cim_matmul_int(_ints(gen, (40, 64), dev), p, cfg=cfg)
    engine.packed_cim_matmul_int(_ints(gen, (4, 64), dev), p, cfg=cfg,
                                 use_kernel=False)
    assert K.ccim_matmul_prepacked_skinny_cuda.launches == 1
    assert K.ccim_matmul_prepacked_general_cuda.launches == 1


def test_analog_subset_of_hybrid_pack(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    hybrid = CCIMConfig(n_dcim_products=3)
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (96, 40), dev), torch.ones((1, 40), device=dev), hybrid)
    subset = CCIMConfig(n_dcim_products=0, adc_bits=9)
    for m in (3, 50):
        x = _ints(gen, (m, 96), dev)
        assert torch.equal(
            engine.packed_cim_matmul_int(x, p, cfg=subset),
            engine.packed_cim_matmul_int(x, p, cfg=subset, use_kernel=False))


# minicpm-2b's fused QKV projection at full width, (K, N)
FULL_K, FULL_N = 2304, 9216


@pytest.mark.parametrize("kernel,m", [("complex_skinny", 4),
                                      ("complex_general", 128),
                                      ("complex_unpacked", 128),
                                      ("unpacked", 128)])
def test_complex_and_unpacked_kernels_equal_plain(dev, kernel, m):
    """Kernels 4-7 at a full-width shape against their plain versions;
    ints compared with torch.equal, one launch counted per call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m)
    xr, xi = _ints(gen, (m, FULL_K), dev), _ints(gen, (m, FULL_K), dev)
    wr, wi = (_ints(gen, (FULL_K, FULL_N), dev),
              _ints(gen, (FULL_K, FULL_N), dev))
    K.reset_launch_counts()
    CK.reset_launch_counts()
    if kernel == "unpacked":
        got = (KO.ccim_matmul_int(xr, wr),)
        want = (KO.ccim_matmul_int(xr, wr, use_kernel=False),)
        launched = K.ccim_matmul_unpacked_cuda.launches
    elif kernel == "complex_unpacked":
        got = CO.ccim_complex_matmul_int(xr, xi, wr, wi)
        want = CO.ccim_complex_matmul_int(xr, xi, wr, wi, use_kernel=False)
        launched = CK.ccim_complex_unpacked_cuda.launches
    else:
        one = torch.ones((1, FULL_N), device=dev)
        pr = engine.pack_quantized_cim_weights(wr, one)
        pi = engine.pack_quantized_cim_weights(wi, one)
        args = (xr, xi, pr.kernel_w, pi.kernel_w, pr.kernel_planes,
                pi.kernel_planes)
        kw = dict(k_dim=FULL_K, n_dim=FULL_N)
        got = CO.ccim_complex_matmul_int_prepacked(*args, **kw)
        want = CO.ccim_complex_matmul_int_prepacked(*args, **kw,
                                                    use_kernel=False)
        launched = (CK.ccim_complex_prepacked_skinny_cuda.launches if m <= 32
                    else CK.ccim_complex_prepacked_general_cuda.launches)
    torch.cuda.synchronize()
    assert launched == 1
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)



def _ragged_unpacked_split_k(m: int, n: int,
                             k_split=K.unpacked_k_split) -> int:
    """The least K from 990 whose padded K (a multiple of 16) an unpacked
    kernel (``k_split`` asks it for its split: row 6's by default) cuts,
    on this card, into several splits with a shorter last one."""
    for k in range(990, 20000, 16):
        kp = -(-k // 16) * 16
        ks = k_split(m, n, kp)
        assert ks > 0 and ks % 64 == 0
        if ks < kp and kp % ks:
            return k
    raise AssertionError(f"no ragged split for M {m}, N {n}")


@pytest.mark.parametrize("m,k,n", [(m, FULL_K, FULL_N) for m in
                                   (1, 4, 32, 33, 128, 129, 512)]
                         + [(2, 1001, 333), (3, 130, 2401), (45, 999, 257),
                            (1, 37, 11), (4, None, 2304), (128, None, 2304)]
                         + [(m, k, n) for k, n in MAMBA_SHAPES
                            for m in (1, 4, 32, 128, 512)])
def test_unpacked_kernel_equals_plain(dev, m, k, n):
    """Kernel 6 (the tensor-core template over a raw-weight fill) through
    ``ccim_matmul_int`` against its plain version: full width (fused QKV)
    at M 1-512, ragged N (rows not 16-byte aligned) and ragged K (Kp a
    multiple of 16, not of the 64-byte stage), K None: a K that the
    kernel's own split leaves a shorter last split, and mamba2-130m's two
    GEMMs (unpacked SSM serving) at M 1-512.  ints compared with
    torch.equal; one launch per call."""
    if k is None:
        k = _ragged_unpacked_split_k(m, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 7 + k + n)
    x, w = _ints(gen, (m, k), dev), _ints(gen, (k, n), dev)
    K.reset_launch_counts()
    got = KO.ccim_matmul_int(x, w)
    torch.cuda.synchronize()
    assert K.ccim_matmul_unpacked_cuda.launches == 1
    want = KO.ccim_matmul_int(x, w, use_kernel=False)
    assert got.dtype == torch.int32 and torch.equal(got, want), (
        K.unpacked_k_split(m, n, -(-k // 16) * 16))


@pytest.mark.parametrize("m,k,n", [(m, FULL_K, FULL_N) for m in
                                   (1, 4, 32, 33, 128, 512)]
                         + [(128, 3072, 2304), (1, 37, 11), (3, 130, 2401),
                            (45, 999, 257), (64, 4096, 64), (32, 1024, 32),
                            (4, None, 2304), (128, None, 2304)])
def test_complex_unpacked_kernel_equals_plain(dev, m, k, n):
    """Kernel row 7 (the tensor-core template over the two-side raw fill)
    through ``ccim_complex_matmul_int`` against its plain version: full
    width (fused QKV) at M 1-512, ``wo`` at M 128 (split over K, which the
    test checks), ragged N (rows not 16-byte aligned) and K (Kp a multiple
    of 16, not of the 64-byte stage), the DoA covariances of the 64- and
    32-element arrays (one output tile, K split over the card), and K
    None: a K that the kernel's own split leaves a shorter last split.
    ints compared with torch.equal; one launch per call."""
    if k is None:
        k = _ragged_unpacked_split_k(m, n, CK.complex_unpacked_k_split)
    kp = -(-k // 16) * 16
    split = CK.complex_unpacked_k_split(m, n, kp)
    assert split > 0 and split % 64 == 0
    if (m, k, n) in ((128, 3072, 2304), (64, 4096, 64), (32, 1024, 32)):
        assert split < kp
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 7 + k + n)
    xr, xi = _ints(gen, (m, k), dev), _ints(gen, (m, k), dev)
    wr, wi = _ints(gen, (k, n), dev), _ints(gen, (k, n), dev)
    CK.reset_launch_counts()
    got = CO.ccim_complex_matmul_int(xr, xi, wr, wi)
    torch.cuda.synchronize()
    assert CK.ccim_complex_unpacked_cuda.launches == 1
    want = CO.ccim_complex_matmul_int(xr, xi, wr, wi, use_kernel=False)
    assert CK.ccim_complex_unpacked_cuda.launches == 1
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b), split

@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (33, 128, 512)
                                   for k, n in FULL_SHAPES]
                         + [(3, 130, 2401), (45, 999, 257), (60, 64, 2401)])
def test_complex_general_kernel_equals_plain(dev, m, k, n):
    """Kernel row 5 (the tensor-core template with two sides) against
    its plain version on a prototype pack: full width at M 33, 128 and
    512 (``wo`` at M 128 is split over K, which the test checks), ragged
    N (2,401 and 257, masked) and K (Kp 144 and 1,008, not multiples of
    the 64-byte stage), M below the skinny bound, and the DoA spectrum
    (M 60, K 64, N 2,401).  ints compared with torch.equal; one launch
    per call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 7 + k + n)
    one = torch.ones((1, n), device=dev)
    pr, pi = (engine.pack_quantized_cim_weights(_ints(gen, (k, n), dev), one)
              for _ in range(2))
    kp = pr.kernel_w.shape[1]
    xr, xi = (KO.pad_k_int8(_ints(gen, (m, k), dev), kp, 1)
              for _ in range(2))
    args = (xr, xi, pr.kernel_w, pr.kernel_planes, pi.kernel_w,
            pi.kernel_planes)
    split = CK.complex_general_k_split(m, n, kp)
    assert split > 0 and split % 64 == 0
    if (m, k, n) == (128, 3072, 2304):
        assert split < kp
    CK.reset_launch_counts()
    got = CK.ccim_complex_prepacked_general_cuda(*args)
    torch.cuda.synchronize()
    assert CK.ccim_complex_prepacked_general_cuda.launches == 1
    want = CK.ccim_complex_prepacked_plain(*args)
    assert CK.ccim_complex_prepacked_general_cuda.launches == 1
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b), split


# (B, Hkv, G, Dh, bs, n_tbl, n_blocks, lengths): lengths an int is the
# largest of random lengths, a tuple the lengths of the rows.  A small GQA
# shape; minicpm-2b's full-width decode shape (48 padded heads, G 1, Dh
# 64) at 10 and at 256 table entries (lengths up to 4096, split walks); a
# GQA shape at Dh 128 over 64 entries (split walks, two head groups); and
# lengths on and off block and split boundaries (5 splits of 48 entries)
PAGED_SHAPES = {"small": (3, 2, 4, 128, 8, 5, 12, 40),
                "minicpm": (8, 48, 1, 64, 16, 10, 64, 160),
                "minicpm_long": (8, 48, 1, 64, 16, 256, 8 * 256 + 1, 4096),
                "gqa_long": (3, 2, 8, 128, 16, 64, 3 * 64 + 1, 1024),
                "boundaries": (8, 8, 1, 64, 16, 48, 8 * 48 + 1,
                               (768, 720, 721, 80, 81, 64, 17, 1)),
                # head dim 256: MHA, gemma2-9b's 16 over 8 and
                # paligemma-3b's 8 over 1, up to 1,024 positions (split);
                # G 16, the tensor-core tile's every row; block size 8
                # with lengths on and off entry and tile boundaries, for
                # the window shorter than the walk (the parametrization's
                # window 7, and 40 in the split-count test)
                "dh256_g1": (4, 4, 1, 256, 16, 64, 4 * 64 + 1, 1024),
                "dh256_g2": (8, 8, 2, 256, 16, 64, 8 * 64 + 1, 1024),
                "dh256_g8": (8, 1, 8, 256, 16, 64, 8 * 64 + 1, 1024),
                "dh256_g16": (4, 2, 16, 256, 16, 64, 4 * 64 + 1, 1024),
                "dh256_local": (6, 2, 2, 256, 8, 40, 6 * 40 + 1,
                                (320, 319, 161, 57, 41, 9))}


def _paged_case(dev, shape):
    B, Hkv, G, Dh, bs, n_tbl, nb, lens = PAGED_SHAPES[shape]
    gen = torch.Generator(device=dev)
    gen.manual_seed(G * 1000 + Dh)
    bf = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, kp, vp = bf(B, Hkv * G, Dh) * 2, bf(nb, bs, Hkv, Dh), bf(nb, bs, Hkv, Dh)
    table = torch.randint(1, nb, (B, n_tbl), generator=gen, device=dev,
                          dtype=torch.int32)
    table[-1] = 0
    if isinstance(lens, tuple):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(1, lens + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
@pytest.mark.parametrize("softcap,window,is_local",
                         [(None, None, False), (50.0, 7, True),
                          (50.0, 7, False)])
def test_paged_attention_kernel_matches_plain(dev, shape, softcap, window,
                                              is_local):
    """Tolerance: the plain version's bf16 p costs up to 2^-9 of
    sum(p |v|) <= 2^-9 max|v| per output, and both outputs are rounded to
    bf16 once: rtol 2^-7, atol 2^-7 max|v|.  The last row's table is all
    trash block.  At window 7 the long shapes' later splits get no work."""
    q, kp, vp, table, lengths = _paged_case(dev, shape)
    B, Hq, Dh = q.shape
    if shape.endswith("_long") or shape == "boundaries" or Dh == 256:
        assert PK.paged_split(B, kp.shape[2], Hq // kp.shape[2],
                              table.shape[1], PK.sm_count(dev), Dh) > 1
    n0 = PK.paged_attention_cuda.launches
    y = PK.paged_attention_cuda(q, kp, vp, table, lengths, is_local,
                                softcap=softcap, window=window)
    r = PR.paged_attention_ref(q, kp, vp, table, lengths, softcap=softcap,
                               window=window, is_local=is_local)
    torch.cuda.synchronize()
    assert PK.paged_attention_cuda.launches == n0 + 1
    assert y.shape == r.shape and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), r.float(), rtol=2 ** -7,
                               atol=2 ** -7 * float(vp.float().abs().max()))


DH256_SHAPES = sorted(s for s in PAGED_SHAPES if s.startswith("dh256"))


@pytest.mark.parametrize("shape", ["minicpm_long"] + DH256_SHAPES)
@pytest.mark.parametrize("n_split", [1, 2, 3, 8, 16, 64])
def test_paged_attention_split_counts_match_plain(dev, n_split, shape):
    """Every split count, not only the one ``paged_split`` picks, at
    minicpm-2b's shape over 256 table entries (random lengths up to
    4,096, the last row all trash block) and at every head dim 256
    shape (gemma2-9b's softcap 50 and, local, its window of 40 there,
    shorter than the walk), to the same tolerance."""
    q, kp, vp, table, lengths = _paged_case(dev, shape)
    wide = q.shape[2] == 256
    kw = dict(softcap=50.0 if wide else None,
              window=40 if shape == "dh256_local" else None)
    local = kw["window"] is not None
    y = PK._launch(q, kp, vp, table, lengths, local, n_split, **kw)
    r = PR.paged_attention_ref(q, kp, vp, table, lengths, is_local=local,
                               **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), r.float(), rtol=2 ** -7,
                               atol=2 ** -7 * float(vp.float().abs().max()))


@pytest.mark.parametrize("shape", ["minicpm", "minicpm_long", "boundaries"]
                         + DH256_SHAPES)
def test_paged_attention_kernel_repeats(dev, shape):
    """Two calls on the same inputs give equal outputs: the warps and
    the splits merge in a fixed order, whichever block ends first."""
    q, kp, vp, table, lengths = _paged_case(dev, shape)
    y1 = PK.paged_attention_cuda(q, kp, vp, table, lengths)
    y2 = PK.paged_attention_cuda(q, kp, vp, table, lengths)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 2304, 9216), (4, 3072, 2304),
                                   (5, 100, 17), (16, 64, 8), (17, 130, 2304),
                                   (33, 1000, 333), (128, 5760, 2304),
                                   (256, 2304, 9216), (257, 3072, 2304),
                                   (512, 5760, 2304), (3, 64, 2304),
                                   (40, 64, 21), (130, 2304, 1002)])
def test_int8_kernel_equals_plain(dev, dtype, m, k, n):
    """W8A8: one launch per call, float32 outputs equal bit for bit, at
    minicpm-2b's widths (M up to 512: token tiles over the grid), at K 64
    (one half stage) and ragged M, K and N (N not a multiple of 8)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 10 + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    IK.reset_launch_counts()
    y_k = IO.int8_matmul(x, w)
    assert IK.int8_w8a8_cuda.launches == 1
    y_p = IO.int8_matmul(x, w, use_kernel=False)
    torch.cuda.synchronize()
    assert IK.int8_w8a8_cuda.launches == 1
    assert y_k.dtype == torch.float32 and torch.equal(y_k, y_p)


def test_int8_kernel_refuses_bad_operands(dev):
    xq = torch.zeros((4, 100), dtype=torch.int8, device=dev)
    wt = torch.zeros((8, 100), dtype=torch.int8, device=dev)
    sx, sw = torch.ones(4, device=dev), torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        IK.int8_w8a8_cuda(xq, wt, sx, sw)
    with pytest.raises(ValueError, match="sw"):
        IK.int8_w8a8_cuda(xq[:, :64].contiguous(), wt[:, :64].contiguous(),
                          sx, sw.double())
    # TMA reads from 16-byte aligned bases: an offset operand raises
    buf = torch.zeros(4 * 64 + 1, dtype=torch.int8, device=dev)
    n0 = IK.int8_w8a8_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        IK.int8_w8a8_cuda(buf[1:].view(4, 64), wt[:, :64].contiguous(),
                          sx, sw)
    assert IK.int8_w8a8_cuda.launches == n0


@pytest.mark.parametrize("splits,ring", [(1, 2), (2, 3), (3, 2), (5, 3),
                                         (8, 2), (8, 3)])
@pytest.mark.parametrize("m", [1, 16, 32, 64, 128])
def test_int8_kernel_plans_equal_plain(dev, m, splits, ring):
    """Other plans than ``plan`` picks, through ``kernel._launch``: every
    cluster size 1-8 and ring depth at each token width, at ``wo``'s K
    (24 stages, cut unevenly by 5) on a ragged N."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 100 + splits * 10 + ring)
    k, n = 3072, 300
    x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    sx = torch.rand(m, generator=gen, device=dev) + 0.5
    sw = torch.rand(n, generator=gen, device=dev) + 0.5
    p = IK.plan(m, n, k, IK.sm_count(dev))
    per = -(-p.k_stages // splits)
    p = dataclasses.replace(p, splits=-(-p.k_stages // per), per_split=per,
                            ring=ring)
    y = IK._launch(x, w, sx, sw, p)
    assert torch.equal(y, IK.int8_w8a8_plain(x, w, sx, sw))


@pytest.mark.parametrize("fidelity", ["exact", "fast_broadcast", "bit_true"])
def test_plain_fidelities_on_the_card_equal_cpu(dev, fidelity):
    """The elementwise and exact fidelities are plain torch: on the card
    they give the CPU's ints (bit-true on a fabricated die included; its
    float32 sums run in the same order)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (9, 200), generator=gen, dtype=torch.int32)
    w = torch.randint(-127, 128, (200, 13), generator=gen, dtype=torch.int32)
    macro = ccim.fabricate(gen)
    want = ccim.cim_matmul_int(x, w, fidelity=fidelity, macro=macro)
    got = ccim.cim_matmul_int(x.to(dev), w.to(dev), fidelity=fidelity,
                              macro=macro.to(dev))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("cfg_kw", [{}, dict(mismatch_granularity="per_macro",
                                         use_split_dac=False,
                                         adc_mismatch_model="averaged"),
                                    dict(n_dcim_products=0, adc_bits=8)])
def test_keyed_dies_on_the_card_equal_cpu(dev, cfg_kw):
    from repro_torch.core import prng
    cfg = CCIMConfig(**cfg_kw)
    for seed in (0, 1, 2 ** 32 - 1):
        want = ccim.fabricate(prng.PRNGKey(seed), cfg)
        got = ccim.fabricate(prng.PRNGKey(seed, dev), cfg)
        assert got.eps_array.is_cuda
        for f in ("eps_array", "adc_cap_eps", "vref_pol_eps"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_sar_noise_codes_on_the_card_equal_cpu(dev):
    """2^20 conversions of the noisy SAR (one key per ADC bit, the fused
    comparator input): the card's codes are the CPU's."""
    from repro_torch.core import prng
    n = 1 << 20
    v = prng.uniform(prng.PRNGKey(3), (n,), -70.0, 70.0)
    macro = ccim.fabricate(prng.PRNGKey(4))
    key = prng.PRNGKey(5)
    want = ccim.sar_adc(v, macro.adc_cap_eps, noise_key=key)
    got = ccim.sar_adc(v.to(dev), macro.adc_cap_eps.to(dev),
                       noise_key=key.to(dev))
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, ccim.sar_adc(v, macro.adc_cap_eps))


@pytest.mark.parametrize("fidelity", ["bit_true", "fast_broadcast", "fast"])
def test_noisy_plain_fidelities_on_the_card_equal_cpu(dev, fidelity):
    """Noisy GEMMs on raw weights are plain torch on any device: the
    card's ints are the CPU's (bit-true on a keyed die, the broadcast's
    row blocks drawing their own flat indices)."""
    from repro_torch.core import prng
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(-127, 128, (9, 200), generator=gen, dtype=torch.int32)
    w = torch.randint(-127, 128, (200, 13), generator=gen, dtype=torch.int32)
    macro = ccim.fabricate(prng.PRNGKey(6))
    key = prng.PRNGKey(7)
    want = ccim.cim_matmul_int(x, w, noise_key=key, fidelity=fidelity,
                               macro=macro)
    got = ccim.cim_matmul_int(x.to(dev), w.to(dev), noise_key=key.to(dev),
                              fidelity=fidelity, macro=macro.to(dev))
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# speculative decoding: row-invariant forwards, the verify contract
# ---------------------------------------------------------------------------

_ROW_COUNTS = (1, 2, 4, 8, 18, 32, 36, 40, 65)


def _smoke_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("minicpm-2b", smoke=True),
                               cim_mode=True)


def _mixed_plan():
    from repro_torch import plan as TP
    return TP.DeploymentPlan.from_dict({
        "mlp/w2": TP.DIGITAL_ENTRY,
        "attn/wq": TP.PlanEntry(cfg=CCIMConfig(n_dcim_products=0, adc_bits=8),
                                label="analog0/adc8"),
        "attn/wo": TP.PlanEntry(cfg=CCIMConfig(n_dcim_products=5, adc_bits=8),
                                label="hybrid5/adc8"),
        "mlp/w3": TP.FLOAT_ENTRY,
    }, default=TP.PlanEntry(cfg=CCIMConfig(acc_len=32, adc_bits=8),
                            label="hybrid3/adc8/L32"))


# every bf16 GEMM a plan's 'float' site can put on the verify path at
# minicpm-2b's width, (K, N): wq/wk/wv, wo, w1/w3, w2
FLOAT_SITE_SHAPES = ((2304, 3072), (3072, 2304), (2304, 5760), (5760, 2304))


def test_model_ops_are_row_invariant(dev):
    """The row-local float operations of a forward give each row the same
    bits whatever the number of rows beside it: the bf16 GEMM (lm_head
    and every float-site projection at minicpm-2b's width), rms_norm and
    the plain attention read."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    n = max(_ROW_COUNTS)
    xf = torch.randn((n, 2304), generator=gen, device=dev)
    x = xf.to(torch.bfloat16)
    w = (torch.randn((2304, 122753), generator=gen, device=dev)
         * 0.02).to(torch.bfloat16)
    g = torch.randn((2304,), generator=gen, device=dev).to(torch.bfloat16)
    # rms_norm sees bf16 rows and the float32 residual sum
    y, r, rf = L.matmul(x, w), L.rms_norm(x, g, 1e-6), L.rms_norm(xf, g, 1e-6)
    cfg = dataclasses.replace(_smoke_cfg(), attn_impl="plain")
    B, Sk, H, Dh = 3, 57, 48, 64
    k = torch.randn((B, Sk, H, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((B, Sk, H, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((B, 9, H, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    kpos = torch.arange(Sk, device=dev)[None].expand(B, Sk)
    kpos = torch.where(kpos < 40, kpos, 10 ** 9)
    qpos = 31 + torch.arange(9, device=dev)[None].expand(B, 9)
    a = L.plain_attention(q, k, v, qpos, kpos, cfg, False)
    for m in _ROW_COUNTS:
        assert torch.equal(L.matmul(x[:m], w), y[:m]), m
        assert torch.equal(L.rms_norm(x[:m], g, 1e-6), r[:m]), m
        assert torch.equal(L.rms_norm(xf[:m], g, 1e-6), rf[:m]), m
    for k_dim, n_dim in FLOAT_SITE_SHAPES:
        xs = torch.randn((n, k_dim), generator=gen, device=dev).to(
            torch.bfloat16)
        ws = (torch.randn((k_dim, n_dim), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        ys = L.matmul(xs, ws)
        for m in _ROW_COUNTS:
            assert torch.equal(L.matmul(xs[:m], ws), ys[:m]), (k_dim, n_dim,
                                                               m)
    for i in range(9):
        one = L.plain_attention(q[:, i:i + 1], k, v, qpos[:, i:i + 1], kpos,
                                cfg, False)
        assert torch.equal(one, a[:, i:i + 1]), i
    # a longer cache whose extra rows are masked gives the same bits
    pad = lambda t: torch.cat([t, t[:, :24]], dim=1)
    kpos2 = torch.cat([kpos, torch.full_like(kpos[:, :24], 10 ** 9)], 1)
    assert torch.equal(L.plain_attention(q, pad(k), pad(v), qpos, kpos2, cfg,
                                         False), a)


@pytest.mark.parametrize("width", ["smoke", "full", "paligemma"])
@pytest.mark.parametrize("plan", [None, "mixed"])
@pytest.mark.parametrize("batch", [2, 4])
def test_verify_step_equals_decode_chain_on_card(dev, width, plan, batch):
    """The verify forward over k+1 = 9 positions (M 18 on kernel row 1 at
    batch 2, M 36 on row 2 at batch 4) gives each position the logits of
    the decode step that would produce it, bit for bit: minicpm-2b at
    smoke and full width, and paligemma-3b's smoke model (G 4 over one kv
    head, its tied head; speculative decoding is text-only)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = _smoke_cfg()
    if width == "full":
        cfg = dataclasses.replace(get_config("minicpm-2b"), cim_mode=True)
    if width == "paligemma":
        cfg = dataclasses.replace(get_config("paligemma-3b", smoke=True),
                                  cim_mode=True)
    if plan:
        cfg = dataclasses.replace(cfg, cim_plan=_mixed_plan())
    S, P = 9, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(batch)
    with torch.inference_mode():
        params = lm.pack_cim_params(lm.init(gen, cfg), cfg)
        prompt = torch.randint(0, cfg.vocab_size, (batch, P), generator=gen,
                               device=dev)
        toks = torch.randint(0, cfg.vocab_size, (batch, S), generator=gen,
                             device=dev)
        cache = lm.init_cache(cfg, batch, P + 2 * S + 1)
        _, cache = lm.prefill(params, cfg, prompt, cache)
        clone = lambda c: {k: v.clone() for k, v in c.items()}
        c, chain = clone(cache), []
        for i in range(S):
            lg, c = lm.decode_step(params, cfg, toks[:, i:i + 1], c)
            chain.append(lg[:, -1])
        K.reset_launch_counts()
        vlg, vc = lm.verify_step(params, cfg, toks, clone(cache))
        torch.cuda.synchronize()
    launched = (K.ccim_matmul_prepacked_skinny_cuda.launches
                if batch * S <= K.SKINNY_M
                else K.ccim_matmul_prepacked_general_cuda.launches)
    # fused QKV, wo, gate-up, w2 a layer; under the plan wq, wk+wv, wo, w1
    assert launched == 4 * cfg.n_layers
    assert torch.equal(vlg, torch.stack(chain, dim=1))
    for key in ("k", "v"):
        assert torch.equal(vc[key], c[key])


def test_moe_expert_path_is_row_invariant(dev):
    """The moe layer's exact path (T * K <= 4096) gives each token the
    same bits whatever the number of tokens beside it and however they
    are batched: the float32 router GEMM in 64-row tiles, the softmax
    over ``_tree_sum``, the stable top-k, the dispatch at capacity T * K
    and the expert GEMMs in 64-row tiles of one shape.  At qwen2-moe's
    full width (60 experts, top 4, D 2048, F 1408; the shared expert's
    bf16 GEMMs in float mode), one layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    p = {k: (v[0] if isinstance(v, torch.Tensor) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in L.moe_init(gen, cfg, 1, torch.bfloat16).items()}
    n = max(_ROW_COUNTS)
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        y, _ = L.moe_apply(p, x, cfg)
        for m in _ROW_COUNTS:
            assert torch.equal(L.moe_apply(p, x[:, :m], cfg)[0], y[:, :m]), m
        # the same tokens as a batch of n one-token rows (a decode step)
        yb, _ = L.moe_apply(p, x.reshape(n, 1, -1), cfg)
        assert torch.equal(yb.reshape(1, n, -1), y)
        # a token routed with 3 others or alone: the decode shapes
        for i in (0, 17, n - 1):
            one, _ = L.moe_apply(p, x[:, i:i + 1], cfg)
            assert torch.equal(one, y[:, i:i + 1]), i


@pytest.mark.parametrize("batch", [2, 4])
def test_moe_verify_step_equals_decode_chain_on_card(dev, batch):
    """qwen2-moe-a2.7b at smoke size, packed: the verify forward over k+1
    = 9 positions (M 18 on row 1, M 36 on row 2) gives each position the
    decode step's logits and KV rows bit for bit; the routed experts'
    dispatch of 18 or 36 tokens equals that of 2 or 4."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                              cim_mode=True)
    S, P = 9, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(batch)
    with torch.inference_mode():
        params = lm.pack_cim_params(lm.init(gen, cfg), cfg)
        prompt = torch.randint(0, cfg.vocab_size, (batch, P), generator=gen,
                               device=dev)
        toks = torch.randint(0, cfg.vocab_size, (batch, S), generator=gen,
                             device=dev)
        cache = lm.init_cache(cfg, batch, P + 2 * S + 1)
        _, cache = lm.prefill(params, cfg, prompt, cache)
        clone = lambda c: {k: v.clone() for k, v in c.items()}
        c, chain = clone(cache), []
        for i in range(S):
            lg, c = lm.decode_step(params, cfg, toks[:, i:i + 1], c)
            chain.append(lg[:, -1])
        K.reset_launch_counts()
        vlg, vc = lm.verify_step(params, cfg, toks, clone(cache))
        torch.cuda.synchronize()
    launched = (K.ccim_matmul_prepacked_skinny_cuda.launches
                if batch * S <= K.SKINNY_M
                else K.ccim_matmul_prepacked_general_cuda.launches)
    # fused QKV, wo, the shared expert's gate-up and w2 a layer
    assert launched == 4 * cfg.n_layers
    assert torch.equal(vlg, torch.stack(chain, dim=1))
    for key in ("k", "v"):
        assert torch.equal(vc[key], c[key])


def test_mixed_plan_serve_kernel_equals_plain(dev):
    """Serving under a mixed plan through the kernels and through their
    plain versions: equal tokens and logits, and the kernels carry every
    packed fast site (wq, wk+wv, wo, w1: 4 a layer a forward)."""
    from repro_torch.launch.serve import serve
    runs = []
    for use_kernel in (None, False):
        K.reset_launch_counts()
        toks, stats = serve("minicpm-2b", smoke=True, batch=4, prompt_len=32,
                            gen=8, plan=_mixed_plan(), use_kernel=use_kernel,
                            return_stats=True)
        runs.append((toks, stats["last_logits"],
                     K.ccim_matmul_prepacked_general_cuda.launches,
                     K.ccim_matmul_prepacked_skinny_cuda.launches))
    (tk, lk, gk, sk), (tp, lp, gp, sp) = runs
    assert (tk == tp).all() and torch.equal(lk, lp)
    assert (gk, sk) == (4 * 2, 4 * 2 * 7) and (gp, sp) == (0, 0)


# ---------------------------------------------------------------------------
# captured serving (launch/graphs.py): replays equal the eager bodies
# ---------------------------------------------------------------------------


def _all_launches():
    from repro_torch.launch.graphs import kernel_wrappers
    return {f.__name__: f.launches for f in kernel_wrappers()}


def _reset_launches():
    from repro_torch.launch.graphs import kernel_wrappers
    for f in kernel_wrappers():
        f.launches = 0


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_captured_serve_equals_eager(dev, width):
    """Lock-step serve replaying its captured decode step gives the eager
    run's tokens and last logits bit for bit, and the same kernel launch
    counts (the replays are credited with what the device ran)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    smoke = width == "smoke"
    params = lm.init(0, get_config("minicpm-2b", smoke=smoke))
    runs = {}
    for graphs in (False, True):
        _reset_launches()
        toks, st = serve("minicpm-2b", smoke=smoke, batch=4, prompt_len=32,
                         gen=16 if smoke else 8, cim=True, params=params,
                         graphs=graphs, return_stats=True)
        torch.cuda.synchronize()
        runs[graphs] = (toks, st, _all_launches())
    (te, se, le), (tc, sc, lc) = runs[False], runs[True]
    assert not se["graphs"] and sc["graphs"] and sc["capture_s"] > 0
    assert (te == tc).all() and torch.equal(se["last_logits"],
                                            sc["last_logits"])
    assert le == lc and lc["ccim_matmul_prepacked_skinny_cuda"] > 0


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_vlm_audio_smoke_serve_kernel_plain_captured(dev, arch):
    """The vlm and audio smoke models' lock-step serve (paligemma with its
    8 frontend embeddings under the prefix mask): through the kernels and
    through their plain versions, tokens and last logits equal; captured
    equal to eager in tokens, logits and launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    params = lm.init(0, get_config(arch, smoke=True))
    runs = {}
    for label, kw in (("plain", dict(use_kernel=False, graphs=False)),
                      ("eager", dict(graphs=False)),
                      ("captured", dict(graphs=True))):
        _reset_launches()
        toks, st = serve(arch, smoke=True, batch=4, prompt_len=32, gen=8,
                         cim=True, params=params, return_stats=True, **kw)
        torch.cuda.synchronize()
        runs[label] = (toks, st["last_logits"], _all_launches())
        assert st["n_frontend"] == (8 if arch == "paligemma-3b" else 0)
    (tp, lp, np_), (te, le, ne), (tc, lc, nc) = (
        runs[k] for k in ("plain", "eager", "captured"))
    assert (tp == te).all() and torch.equal(lp, le)
    assert (te == tc).all() and torch.equal(le, lc)
    assert ne == nc and ne["ccim_matmul_prepacked_skinny_cuda"] > 0
    assert ne["ccim_matmul_prepacked_general_cuda"] == 8       # 4 a layer
    assert not any(np_.values())


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_captured_ssm_decode_equals_eager(dev, width):
    """mamba2-130m's decode step (packed, prototype macro) replayed from
    one graph over 8 steps against 8 eager steps from the same prefill:
    logits, the SSM state, both conv states and the positions equal
    (``==``) after every step; the graph credits the packed tree's two
    row-1 GEMMs a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("mamba2-130m",
                                         smoke=width == "smoke"),
                              cim_mode=True)
    packed = lm.pack_cim_params(lm.init(0, cfg), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, cfg.ssm_chunk),
                           generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab_size, (8, 4, 1), generator=gen,
                          device=dev)
    caches = []
    with torch.inference_mode():
        for _ in range(2):
            _, c = lm.prefill(packed, cfg, prompt,
                              lm.init_cache(cfg, 4, 1, device=dev))
            caches.append(c)
        eager, replay = caches
        tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)
        graph = StepGraph(lambda: lm.decode_step(packed, cfg, tok,
                                                 replay)[0], dev)
        for i in range(8):
            want, _ = lm.decode_step(packed, cfg, steps[i], eager)
            tok.copy_(steps[i])
            got = graph()
            assert torch.equal(got, want), i
            for key in ("ssm", "conv_x", "conv_bc", "pos"):
                assert torch.equal(replay[key], eager[key]), (i, key)
    assert graph.replays == 7
    assert graph.launches == {"ccim_matmul_prepacked_skinny_cuda":
                              2 * cfg.n_layers}


@pytest.mark.parametrize("width,paged", [("smoke", False), ("full", False),
                                         ("full", True)])
def test_captured_hybrid_decode_equals_eager(dev, width, paged):
    """zamba2-1.2b's decode step (packed, prototype macro; at full width
    cut to 7 layers: one shared-block invocation and a remainder layer)
    replayed from one graph over 8 steps against 8 eager steps from the
    same prefill, with a contiguous or (at full width: row 3 takes head
    dims 64-256, the smoke config's is 32) a paged cache: logits, the SSM,
    conv and shared-KV state and the positions equal (``==``) after every
    step; the graph credits the packed tree's GEMMs a forward and, paged,
    one row-3 launch an invocation."""
    from repro_torch.configs import get_config
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("zamba2-1.2b",
                                         smoke=width == "smoke"),
                              cim_mode=True)
    if width == "full":
        cfg = dataclasses.replace(cfg, n_layers=7)
    packed = lm.pack_cim_params(lm.init(0, cfg), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    S, B, bs = cfg.ssm_chunk, 4, 16
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    steps = torch.randint(0, cfg.vocab_size, (8, B, 1), generator=gen,
                          device=dev)
    n_tbl = -(-(S + 8) // bs)

    def cache():
        if not paged:
            return lm.init_cache(cfg, B, S + 8, device=dev)
        c = lm.init_paged_cache(cfg, B, B * n_tbl + 1, bs, n_tbl,
                                device=dev)
        c["table"].copy_(1 + torch.arange(B * n_tbl, device=dev,
                                          dtype=torch.int32).view(B, n_tbl))
        return c
    caches = []
    with torch.inference_mode():
        for _ in range(2):
            _, c = lm.prefill(packed, cfg, prompt, cache())
            caches.append(c)
        eager, replay = caches
        tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        graph = StepGraph(lambda: lm.decode_step(packed, cfg, tok,
                                                 replay)[0], dev)
        for i in range(8):
            want, _ = lm.decode_step(packed, cfg, steps[i], eager)
            tok.copy_(steps[i])
            got = graph()
            assert torch.equal(got, want), i
            for key in ("ssm", "conv_x", "conv_bc", "shared_k", "shared_v",
                        "pos"):
                assert torch.equal(replay[key], eager[key]), (i, key)
    n_inv = lm.n_shared_invocations(cfg)
    assert graph.replays == 7 and n_inv == (2 if width == "smoke" else 1)
    want = {"ccim_matmul_prepacked_skinny_cuda":
            2 * cfg.n_layers + 4 * n_inv}
    if paged:
        want["paged_attention_cuda"] = n_inv
    assert graph.launches == want


@pytest.mark.parametrize("batch", [2, 4])
def test_captured_speculative_equals_eager(dev, batch):
    """The speculative round as one graph (verify M 18 on kernel row 1 at
    batch 2, M 36 on row 2 at batch 4): tokens, round counts and launches
    equal the eager rounds', and tokens equal lock-step serving's, which
    ``compare_baseline`` asserts (captured too)."""
    from repro_torch.launch.serve import serve_speculative
    runs = {}
    for graphs in (False, True):
        _reset_launches()
        toks, st = serve_speculative("minicpm-2b", smoke=True, batch=batch,
                                     prompt_len=16, gen=24, draft_k=8,
                                     graphs=graphs, compare_baseline=False,
                                     return_stats=True)
        torch.cuda.synchronize()
        runs[graphs] = (toks, st, _all_launches())
        serve_speculative("minicpm-2b", smoke=True, batch=batch,
                          prompt_len=16, gen=24, draft_k=8, graphs=graphs)
    (te, se, le), (tc, sc, lc) = runs[False], runs[True]
    assert (te == tc).all() and le == lc
    for key in ("n_rounds", "n_drafted", "n_accepted"):
        assert se[key] == sc[key], key
    assert sc["graphs"] and sc["n_rounds"] >= 2


@pytest.mark.parametrize("mode", ["contiguous", "paged", "speculative"])
def test_captured_scheduler_equals_eager(dev, mode):
    """The scheduler's pooled step (and, speculative, each rung's round)
    replayed from graphs: pool tokens, iterations by branch and launches
    equal the eager scheduler's, over two runs of one scheduler (the
    graphs outlive a run)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.launch import scheduler as TS
    from repro_torch.launch.paging import PagedLayout
    from repro_torch.models import lm
    from repro_torch.plan import draft_plan_for_model
    cfg = dc.replace(get_config("minicpm-2b", smoke=True), cim_mode=True)
    if mode == "paged":                 # the paged kernel takes Dh 64, 128
        cfg = dc.replace(cfg, d_head=64)
    with torch.inference_mode():
        params = lm.pack_cim_params(lm.init(0, cfg), cfg)
    kw = dict(slots=4, prompt_len=16, max_new_cap=12)
    if mode == "paged":
        kw.update(paged=PagedLayout(block_size=4, n_tbl=7, n_blocks=40),
                  prefill_chunk=8)
    if mode == "speculative":
        kw.update(draft_k=4, adaptive_draft_k=True,
                  draft_plan=draft_plan_for_model(cfg, 5))
    reqs = TS.mixed_length_requests(8, 16, cfg.vocab_size,
                                    stop_lengths=(3, 12, 6, 9), seed=0)
    out = {}
    for graphs in (False, True):
        sched = TS.ContinuousBatchingScheduler(params, cfg, graphs=graphs,
                                               **kw)
        for turn in range(2):
            _reset_launches()
            rep = sched.run(reqs)
            torch.cuda.synchronize()
            out[graphs, turn] = (rep.tokens_by_rid(), rep.branch_counts,
                                 _all_launches())
        assert sched.graphs is graphs and bool(sched.graph_stats()) is graphs
    want = out[False, 0]
    for key, (toks, counts, launches) in out.items():
        assert counts == want[1] and launches == want[2], key
        assert sorted(toks) == sorted(want[0])
        for rid in toks:
            assert (toks[rid] == want[0][rid]).all(), (key, rid)
    if mode == "paged":
        assert want[2]["paged_attention_cuda"] > 0


# ---------------------------------------------------------------------------
# threefry on the card (core/prng.py), sampled and noisy serving
# ---------------------------------------------------------------------------


def test_prng_on_card_equals_cpu(dev):
    """Keys, bits and uniforms are integer work and exact float steps;
    normals and Gumbels are single IEEE operations in the same order
    (XLA's CPU approximations written out): all equal the CPU port's."""
    from repro_torch.core import prng
    for seed in (0, 2 ** 32 - 1):
        kc, kd = prng.PRNGKey(seed), prng.PRNGKey(seed, dev)
        assert torch.equal(prng.split(kd, 3).cpu(), prng.split(kc, 3))
        keys_c = prng.split(kc, 6)
        assert torch.equal(prng.split(keys_c.to(dev)).cpu(),
                           prng.split(keys_c))
        assert torch.equal(prng.fold_in(kd, 12345).cpu(),
                           prng.fold_in(kc, 12345))
        shape = (3, 1 << 16)
        assert torch.equal(prng.bits(kd, shape).cpu(), prng.bits(kc, shape))
        assert torch.equal(prng.uniform(kd, shape, -3.0, 5.0).cpu(),
                           prng.uniform(kc, shape, -3.0, 5.0))
        assert torch.equal(prng.normal(kd, shape).cpu(),
                           prng.normal(kc, shape))
        assert torch.equal(prng.gumbel(kd, shape).cpu(),
                           prng.gumbel(kc, shape))


@pytest.mark.parametrize("shape", [(4, 144, 64), (33, 40, 300)])
def test_noisy_fast_gemm_on_card_equals_cpu(dev, shape):
    """The noisy chunked GEMM on the card: the same draws, the same fused
    multiply-adds (float64, one rounding) and exact float32 dots give the
    CPU port's ints."""
    from repro_torch.core import prng
    M, C, N = shape
    gen = torch.Generator().manual_seed(M * C)
    xq = torch.randint(-127, 128, (M, C, 16), generator=gen,
                       dtype=torch.int32)
    wq = torch.randint(-127, 128, (C, 16, N), generator=gen,
                       dtype=torch.int32)
    key = prng.fold_in(prng.PRNGKey(0), 7)
    want = ccim.hybrid_mac_fast_gemm(xq, wq, key)
    got = ccim.hybrid_mac_fast_gemm(xq.to(dev), wq.to(dev), key.to(dev))
    assert torch.equal(got.cpu(), want)


def test_captured_sampled_serve_equals_eager(dev):
    """A sampled (T 0.7) decode step, its key advanced in place by the
    replayed graph, gives the eager run's tokens and logits; a noisy
    serve's captured decode (noise drawn inside the graph) too."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    params = lm.init(0, get_config("minicpm-2b", smoke=True))
    for kw in (dict(temperature=0.7), dict(noise_seed=0)):
        runs = {}
        for graphs in (False, True):
            runs[graphs] = serve("minicpm-2b", batch=4, prompt_len=16,
                                 gen=12, cim=True, params=params,
                                 graphs=graphs, return_stats=True, **kw)
        (te, se), (tc, sc) = runs[False], runs[True]
        assert sc["graphs"] and (te == tc).all(), kw
        assert torch.equal(se["last_logits"], sc["last_logits"]), kw


# ---------------------------------------------------------------------------
# unpacked serving and the planner: raw weights through kernel row 6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [4, 32, 128])
def test_unpacked_forward_equals_packed_at_full_width(dev, m):
    """A full-width forward over M = batch x tokens rows on the raw weights
    (kernel row 6, 4 launches a layer: QKV, wo, w1+w3, w2) equals the
    forward on their pack (row 1 at M <= 32, row 2 above) bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("minicpm-2b"), cim_mode=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(m)
    batch = 1 if m == 4 else 4
    with torch.inference_mode():
        params = lm.init(gen, cfg)
        toks = torch.randint(0, cfg.vocab_size, (batch, m // batch),
                             generator=gen, device=dev)
        K.reset_launch_counts()
        raw, _ = lm.forward(params, cfg, toks)
        torch.cuda.synchronize()
        n_raw = K.ccim_matmul_unpacked_cuda.launches
        packed = lm.pack_cim_params(params, cfg)
        del params
        K.reset_launch_counts()
        want, _ = lm.forward(packed, cfg, toks)
        torch.cuda.synchronize()
    row = (K.ccim_matmul_prepacked_skinny_cuda if m <= K.SKINNY_M
           else K.ccim_matmul_prepacked_general_cuda)
    assert n_raw == 4 * cfg.n_layers and row.launches == 4 * cfg.n_layers
    assert K.ccim_matmul_unpacked_cuda.launches == 0
    assert torch.equal(raw, want)


def test_profile_through_kernels_equals_plain(dev):
    """At smoke width, the noise-free profile of every site under the
    digital, prototype and hybrid3/adc8/L32 candidates is the same table
    through the kernels (rows 6 and 1) as through their plain versions."""
    from repro_torch import plan as TP
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("minicpm-2b", smoke=True)
    params = lm.init(0, cfg)
    toks = TP.calibration_batch(cfg)
    cands = [TP.digital_candidate(), TP.prototype_candidate(),
             TP.make_candidate("hybrid3/adc8/L32",
                               CCIMConfig(acc_len=32, adc_bits=8))]
    tables = {}
    for use_kernel in (None, False):
        c = dataclasses.replace(cfg, cim_use_kernel=use_kernel)
        K.reset_launch_counts()
        tables[use_kernel] = TP.profile_sensitivities(
            params, c, toks, cands, noise_seed=None).as_table()
        launched = (K.ccim_matmul_unpacked_cuda.launches,
                    K.ccim_matmul_prepacked_skinny_cuda.launches)
        if use_kernel is None:
            # the prototype's 7 forwards on row 6, the L32 point's on row 1
            assert launched == (7 * cfg.n_layers, 7 * cfg.n_layers)
        else:
            assert launched == (0, 0)
    assert tables[None] == tables[False]


# ---------------------------------------------------------------------------
# telemetry: the ADC clip count of rows 1 and 2, rings in captured steps
# ---------------------------------------------------------------------------

# (design point, M) cases of the clip count: the prototype at ADC 7 and 5,
# the all-analog macro at 5 (which clips on uniform ints), every acc_len
_CLIP_CFGS = [dict(adc_bits=7), dict(adc_bits=5),
              dict(adc_bits=5, n_dcim_products=0),
              dict(adc_bits=5, n_dcim_products=0, acc_len=8),
              dict(adc_bits=6, n_dcim_products=1, acc_len=32),
              dict(adc_bits=5, n_dcim_products=0, acc_len=64)]


@pytest.mark.parametrize("cfg_kw", _CLIP_CFGS)
@pytest.mark.parametrize("shape", [(5, 520, 70), (32, 520, 70),
                                   (33, 520, 70), (100, 1000, 300),
                                   (4, 2304, 6912), (128, 2304, 11520),
                                   (4, 5760, 2304), (128, 5760, 2304)])
def test_clip_count_equals_plain(dev, cfg_kw, shape):
    """Rows 1 (M <= 32) and 2 count the conversions whose ADC code
    clipped exactly as the plain version does, ragged M and N and the
    full-width shapes included; the outputs stay equal."""
    from repro_torch.obs import taps
    m, k, n = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 7 + k + n)
    cfg = CCIMConfig(**cfg_kw)
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (k, n), dev), torch.ones((1, n), device=dev), cfg)
    x = _ints(gen, (m, k), dev)
    got = {}
    for use_kernel in (None, False):
        K.reset_launch_counts()
        with taps.collect() as fr:
            y = engine.packed_cim_matmul_int(x, p, cfg=cfg,
                                             use_kernel=use_kernel)
            got[use_kernel] = (y, int(taps.drain_sum(fr, "adc_clip")))
        launched = (K.ccim_matmul_prepacked_skinny_cuda.launches
                    + K.ccim_matmul_prepacked_general_cuda.launches)
        assert launched == (1 if use_kernel is None else 0)
    assert torch.equal(got[None][0], got[False][0])
    assert got[None][1] == got[False][1]
    if cfg_kw.get("n_dcim_products") == 0 and cfg.acc_len >= 16:
        assert got[None][1] > 0


def test_clip_counter_off_without_a_collector(dev):
    """With no collector open the kernels take no counter; an explicit
    ``clips`` buffer accumulates over calls."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cfg = CCIMConfig(adc_bits=5, n_dcim_products=0)
    p = engine.pack_quantized_cim_weights(       # K 512: no padding
        _ints(gen, (512, 70), dev), torch.ones((1, 70), device=dev), cfg)
    x = _ints(gen, (4, 512), dev).to(torch.int8)
    meta = dict(acc_len=16, x_bits=(), dcim_lsb=cfg.dcim_lsb,
                adc_half=cfg.adc_half_range)
    buf = torch.zeros((1,), dtype=torch.int32, device=dev)
    y0 = K.ccim_matmul_prepacked_skinny_cuda(x, p.kernel_w, p.kernel_planes,
                                             **meta)
    y1 = K.ccim_matmul_prepacked_skinny_cuda(x, p.kernel_w, p.kernel_planes,
                                             **meta, clips=buf)
    one = int(buf)
    K.ccim_matmul_prepacked_skinny_cuda(x, p.kernel_w, p.kernel_planes,
                                        **meta, clips=buf)
    plain = torch.zeros((1,), dtype=torch.int32, device=dev)
    K.ccim_matmul_prepacked_plain(x, p.kernel_w, p.kernel_planes, **meta,
                                  clips=plain)
    assert torch.equal(y0, y1) and one > 0
    assert int(buf) == 2 * one and int(plain) == one
    with pytest.raises(ValueError):
        K.ccim_matmul_prepacked_skinny_cuda(
            x, p.kernel_w, p.kernel_planes, **meta,
            clips=torch.zeros((1,), dtype=torch.int64, device=dev))


def _obs_sched(obs, graphs, mode="paged"):
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.launch import scheduler as TS
    from repro_torch.launch.paging import PagedLayout
    from repro_torch.models import lm
    from repro_torch.plan import draft_plan_for_model
    cfg = dc.replace(get_config("minicpm-2b", smoke=True), cim_mode=True,
                     d_head=64)
    with torch.inference_mode():
        params = lm.pack_cim_params(lm.init(0, cfg), cfg)
    kw = dict(slots=4, prompt_len=16, max_new_cap=12, obs=obs, graphs=graphs)
    if mode == "paged":
        kw.update(paged=PagedLayout(block_size=4, n_tbl=7, n_blocks=40),
                  prefill_chunk=8)
    else:
        kw.update(draft_k=4, draft_plan=draft_plan_for_model(cfg, 5))
    reqs = TS.mixed_length_requests(8, 16, cfg.vocab_size,
                                    stop_lengths=(3, 12, 6, 9), seed=0)
    return TS.ContinuousBatchingScheduler(params, cfg, **kw), reqs


@pytest.mark.parametrize("mode", ["paged", "speculative"])
def test_captured_rings_equal_eager(dev, mode):
    """The ring writes a captured step replays equal the eager step's:
    the harvested snapshot (the wall clock aside), every per-iteration
    sample and the ADC clips, over two runs of one scheduler; tokens equal
    the metrics-off run's, one flags read an iteration."""
    import numpy as np
    from repro_torch.obs import ObsConfig
    wall = ("wall_s", "iter_s_est", "ttft_p50_s", "ttft_p95_s")
    snaps = {}
    off_sched, reqs = _obs_sched(None, False, mode)
    want = off_sched.run(reqs).tokens_by_rid()
    for graphs in (False, True):
        sched, _ = _obs_sched(ObsConfig(), graphs, mode)
        for turn in range(2):
            rep = sched.run(reqs)
            assert rep.host_syncs == rep.n_iter + 1
            for rid, toks in rep.tokens_by_rid().items():
                assert (toks == want[rid]).all(), (graphs, turn, rid)
            d = rep.obs.to_dict()
            d = {k_: v for k_, v in d.items() if k_ not in wall}
            d["spans"] = [{k_: v for k_, v in s.items() if k_ != "ttft_s_est"}
                          for s in d["spans"]]
            snaps[graphs, turn] = (d, rep.obs.iter_samples)
    base = snaps[False, 0]
    for key, (d, samples) in snaps.items():
        assert d == base[0], key
        for name, col in samples.items():
            assert np.array_equal(col, base[1][name]), (key, name)
    if mode == "speculative":
        assert base[0]["counters"]["adc_clip"] > 0


def test_metrics_off_graph_unchanged_by_telemetry(dev):
    """A metrics-off scheduler's captured step holds the same device
    nodes (kernels, in order) before and after a metrics-on scheduler
    ran in the process, and the metrics-on graph the same serving-kernel
    nodes: the rings add only their own small kernels."""
    import re
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.fingerprint import graph_node_names, graph_nodes
    pat = {s: re.compile(rf"(?<![A-Za-z_]){s}")
           for s in ("skinny_kernel", "general_kernel", "paged_attn_walk")}
    names = []
    for obs in (None, ObsConfig(), None):
        sched, reqs = _obs_sched(obs, True)
        sched.run(reqs)
        g = sched._graphs[0]
        names.append((graph_node_names(g), graph_nodes(g, pat)[0]))
    assert names[0][0] == names[2][0]
    assert names[1][1] == names[0][1] and any(names[0][1].values())
    assert len(names[1][0]) > len(names[0][0])


_DRIFT = dict(seed=3, gain_amp=0.6, offset_lsb=2.0, schedule="ramp",
              onset=4, period=16)


def test_faulted_gemm_replays_equal_eager_under_a_ramp(dev):
    """A fault-armed fast GEMM captured once replays the drift at every
    clock the device tensor holds: equal to its eager call and to the
    CPU port at clocks 0-40 (the ramp from onset to full), and unlike the
    clean output past the onset."""
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.resilience import faults as F
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    w = _ints(gen, (520, 96), dev)
    p = engine.pack_quantized_cim_weights(
        w, torch.ones((1, 96), device=dev), ccim.DEFAULT_CONFIG)
    x = _ints(gen, (4, 520), dev)
    cpu = dataclasses.replace(p, scale=p.scale.cpu(), kernel_w=p.kernel_w.cpu(),
                              kernel_planes=p.kernel_planes.cpu())
    clk = torch.zeros((), dtype=torch.int32, device=dev)
    mm = lambda xx, pp: engine.packed_cim_matmul_int(xx, pp, p.cfg)
    clean = mm(x, p)
    with torch.inference_mode(), F.inject(F.FaultModel(**_DRIFT)), \
            F.clock(clk):
        g = StepGraph(lambda: mm(x, p), dev)
        g()
        for t in range(41):
            clk.fill_(t)
            got = g().clone()
            assert torch.equal(got, mm(x, p)), t
            with F.clock(torch.tensor(t, dtype=torch.int32)):
                assert torch.equal(got.cpu(), mm(x.cpu(), cpu)), t
            if t > 8:
                assert not torch.equal(got, clean), t


def test_guarded_server_captures_up_front(dev):
    """``GuardedServer`` captures every rung's graphs in ``compile_for``
    and none while serving; the clean run equals the plain captured
    scheduler's tokens, and the chaos run (drift ramp) reaches RED and the
    digital rung, its log equal to an eager (uncaptured) server's."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.launch import scheduler as TS
    from repro_torch.models import lm
    from repro_torch.resilience import failover as FO
    from repro_torch.resilience import faults as F
    from repro_torch.resilience import watchdog as W
    cfg = dc.replace(get_config("minicpm-2b", smoke=True), cim_mode=True)
    with torch.inference_mode():
        params = lm.pack_cim_params(lm.init(0, cfg), cfg)
    reqs = TS.mixed_length_requests(4, 8, cfg.vocab_size,
                                    stop_lengths=(4, 16, 8, 12), seed=0)
    kw = dict(slots=2, prompt_len=8, max_new_cap=16, segment_iters=4)
    want = TS.ContinuousBatchingScheduler(
        params, cfg, slots=2, prompt_len=8, max_new_cap=16).run(reqs)
    server = FO.GuardedServer(params, cfg, watchdog=W.Watchdog(),
                              probe=FO.default_probe(params), **kw)
    server.compile_for(len(reqs))
    assert server.captures() == 3
    rep, log = server.run(reqs)
    assert server.captures() == 3 and not log.actions
    for rid, toks in want.tokens_by_rid().items():
        assert (rep.tokens_by_rid()[rid] == toks).all(), rid
    logs = []
    for graphs in (True, False):
        fault = F.FaultModel(**_DRIFT)
        s = FO.GuardedServer(
            params, cfg, fault=fault, graphs=graphs,
            watchdog=W.Watchdog(W.WatchdogConfig(debounce=1)),
            probe=FO.default_probe(params, fault=fault), **kw)
        logs.append(s.run(reqs)[1].to_dict())
        assert s.watchdog.state == W.RED
    assert logs[0] == logs[1]
    assert logs[0]["final_rung"] == 2


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _cpu_init(monkeypatch):
    """``lm.init`` makes its weights on the CPU and copies them to the
    device asked for, so a card run and a CPU run start from the same
    weights."""
    from repro_torch import resolve_device
    from repro_torch.models import lm
    from repro_torch.optim import tree_map
    init = lm.init

    def cpu_init(key, cfg, device=None):
        dev = resolve_device(device)
        return tree_map(lambda p: p.to(dev), init(key, cfg, device="cpu"))
    monkeypatch.setattr(lm, "init", cpu_init)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-130m"])
def test_train_step_kernel_equals_plain(dev, deterministic, arch,
                                        monkeypatch):
    """One QAT train step (forward with per-layer recomputation, STE
    backward, AdamW) at smoke size through ``train``, on row 6 and on its
    plain version (``cim_use_kernel=False`` in the config ``train``
    reads) from the same weights: the loss and every updated leaf and
    moment ``==``; row 6 launched twice per raw projection (forward and
    recompute), the plain run none."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.optim import tree_leaves
    out = {}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        monkeypatch.setattr(T, "get_config", lambda a, smoke, uk=use_kernel:
                            dataclasses.replace(get_config(a, smoke=smoke),
                                                cim_use_kernel=uk))
        K.reset_launch_counts()
        params, opt, losses = T.train(arch, smoke=True, steps=1, batch=2,
                                      seq=32, cim=True, log_every=100,
                                      device=dev)
        out[label] = (losses, tree_leaves(params), tree_leaves(opt["m"]),
                      K.ccim_matmul_unpacked_cuda.launches)
    (lk, pk, mk, nk), (lp, pp, mp, npl) = out["kernel"], out["plain"]
    assert lk == lp
    for a, b in zip(pk + mk, pp + mp):
        assert torch.equal(a, b)
    per_layer = 2 if arch == "mamba2-130m" else 4
    assert nk == 2 * per_layer * get_config(arch, smoke=True).n_layers
    assert npl == 0


# The card against the CPU path (module docstring).  The card sums its
# products, norms and CE in cuBLAS's and torch's orders where the CPU
# path takes XLA-CPU's, so bf16 activations part by a step here and
# there and carry it through the layers.  Measured on an H100 with
# ``tools/train_parity_probe.py --card``:
CARD_LOSS_RTOL = 2 ** -12   # lm_loss, relative: at most 1.05e-4
CARD_GRAD_TOL = 2 ** -5     # of a leaf's largest |g|, the CPU path's
#                             tolerance against the reference: at most
#                             1.96e-2
CARD_ADAM_TOL = 2 ** -20    # float32 AdamW state (the global norm's
#                             order, the sqrt): at most 1.4e-7
CARD_TRAIN_ATOL = 2 ** -8   # a loss of the 60-step run, nats: at most
#                             1.7e-3 (the CPU path against the
#                             reference over the same steps: 1.7e-3)


@pytest.mark.parametrize("arch,cim", [
    ("minicpm-2b", False), ("minicpm-2b", True),
    ("gemma2-9b", False),          # softcaps, the tied head, GELU
    ("mamba2-130m", True),         # the SSD layer under the macro
    ("qwen2-moe-a2.7b", False),    # the aux loss, the router
])
def test_lm_loss_and_grads_on_card_equal_cpu(dev, arch, cim):
    """``lm.lm_loss`` and every leaf's gradient at smoke size on the card
    (row 6 under ``--cim``, the flash backward, the chunked CE, the STE's
    cuBLAS products) against the CPU path from the same weights
    (``lm.init`` on the CPU, copied) and tokens: the loss within
    ``CARD_LOSS_RTOL``, each gradient element within ``CARD_GRAD_TOL``
    of its leaf's largest."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch, smoke=True), cim_mode=cim)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32))).long()
    cpu = lm.init(0, cfg, device="cpu")
    out = []
    for params in (cpu, tree_map(lambda p: p.to(dev), cpu)):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm.lm_loss(params, cfg, toks.to(leaves[0].device))
        grads = torch.autograd.grad(loss, leaves)
        assert all(g.dtype == p.dtype for g, p in zip(grads, leaves))
        out.append((float(loss.detach()),
                    [g.float().cpu() for g in grads]))
    (want, gw), (got, gc) = out
    assert abs(got - want) <= CARD_LOSS_RTOL * abs(want), (got, want)
    for i, (a, b) in enumerate(zip(gc, gw)):
        atol = CARD_GRAD_TOL * float(b.abs().max())
        assert float((a - b).abs().max()) <= atol, i


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_on_card_equals_cpu(dev, moment_dtype):
    """Two AdamW updates (WSD, a first gradient large enough that the
    global-norm clip acts) from the same parameters and gradients on the
    card and on the CPU: float32 parameters and moments within
    ``CARD_ADAM_TOL`` relative or of the leaf's largest, bf16 ones within
    one bf16 step."""
    import numpy as np
    from repro_torch.optim import OptConfig, adamw_update, init_opt_state
    from repro_torch.optim import tree_leaves
    rng = np.random.default_rng(6)

    def tree(scale):
        return {"a": torch.tensor(rng.standard_normal((64, 48)) * scale,
                                  dtype=torch.bfloat16),
                "b": {"c": torch.tensor(rng.standard_normal(40) * scale,
                                        dtype=torch.float32)}}
    p0, grads = tree(0.1), [tree(3.0), tree(0.05)]
    cfg = OptConfig(schedule="wsd", warmup=2, total_steps=10,
                    moment_dtype=moment_dtype)
    out = []
    for d in ("cpu", dev):
        to = lambda t: {"a": t["a"].to(d, copy=True),
                            "b": {"c": t["b"]["c"].to(d, copy=True)}}
        p = to(p0)
        s = init_opt_state(p, cfg)
        for g in grads:
            p, s = adamw_update(p, to(g), s, cfg)
        out.append([t.cpu() for t in tree_leaves(p) + tree_leaves(s["m"])
                    + tree_leaves(s["v"])])
    for want, got in zip(*out):
        assert got.dtype == want.dtype
        w, g = want.float(), got.float()
        step = CARD_ADAM_TOL if want.dtype == torch.float32 else 2 ** -7
        tol = step * torch.maximum(w.abs(), w.abs().max())
        assert bool(((g - w).abs() <= tol).all()), (want.dtype, w, g)


def test_train_loss_decreases_on_card(dev, monkeypatch):
    """Twin of the reference's ``test_train_loss_decreases``: 60 steps of
    minicpm-2b at smoke on the card, batch 4 x seq 48, against the same
    60 steps on the CPU path from the same weights (``lm.init`` on the
    CPU, copied; ``_cpu_init``).  Each of the card's losses is within
    ``CARD_TRAIN_ATOL`` of the CPU's, and the reference's criterion holds
    on the card: the second half's mean loss below the first half's."""
    from repro_torch.launch.train import train
    _cpu_init(monkeypatch)
    kw = dict(smoke=True, steps=60, batch=4, seq=48, log_every=100)
    _, _, want = train("minicpm-2b", device="cpu", **kw)
    _, _, got = train("minicpm-2b", device=dev, **kw)
    got, want = torch.tensor(got), torch.tensor(want)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= CARD_TRAIN_ATOL, (got, want)
    assert float(got[30:].mean()) < float(got[:30].mean()), got
