"""Port parity: the plain versions of the port's macro GEMM kernels
(kernels/ccim_matmul: prepacked and unpacked) against the reference's
Pallas kernels run in interpret mode, and against the integer oracles.

All outputs are int32 and compared with ``==``.  The CUDA kernels
themselves run only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the dispatcher routes CPU tensors to the plain
version, and the wrappers refuse CPU tensors.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import ccim as Jc
from repro.core import engine as Je
from repro.kernels.ccim_matmul import ccim_matmul_ref as jax_ref
from repro.kernels.ccim_matmul import kernel as jkernel
from repro.kernels.ccim_matmul import ops as jops
from repro_torch.core import ccim as Tc
from repro_torch.core import engine as Te
from repro_torch.kernels import build
from repro_torch.kernels.ccim_complex import kernel as CK
from repro_torch.kernels.ccim_matmul import kernel as K
from repro_torch.kernels.ccim_matmul import ops as tops
from repro_torch.kernels.ccim_matmul.ref import ccim_matmul_ref as torch_ref
from repro_torch.kernels.paged_attn import kernel as PK
from repro_torch.kernels.paged_attn import ref as PR

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


# (n_dcim, adc_bits, acc_len, M, K); the skinny cases at M 8 and 16 take
# a K that is not a multiple of the reference kernel's 512-wide K block
PALLAS_CASES = [(3, 7, 16, 3, 96), (3, 7, 16, 40, 96), (0, 9, 8, 5, 96),
                (6, 8, 64, 36, 96), (3, 7, 16, 8, 1040), (3, 7, 16, 16, 1040),
                (6, 8, 64, 16, 1040)]


@pytest.mark.parametrize(
    "nd,adc,acc,m,k", PALLAS_CASES,
    ids=["-".join(map(str, c[:4])) + ("" if c[4] == 96 else f"-k{c[4]}")
         for c in PALLAS_CASES])
def test_plain_equals_pallas_interpret(nd, adc, acc, m, k):
    """Reference: ccim_matmul_int_prepacked with use_pallas=True in
    interpret mode (the skinny kernel at M <= 32, the general one
    above)."""
    jc = Jc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
    tc = Tc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
    rng = np.random.default_rng(nd + adc + acc + m + (k - 96))
    K_, N = k, 40
    w = rng.integers(-127, 128, (K_, N)).astype(np.int32)
    x = rng.integers(-127, 128, (m, K_)).astype(np.int32)
    one = np.ones((1, N), np.float32)
    jp = Je.pack_quantized_cim_weights(jnp.asarray(w), jnp.asarray(one), jc)
    x_bits = tuple(Jc._dcim_by_j(jc))
    yj = jops.ccim_matmul_int_prepacked(
        jnp.asarray(x), jp.pallas_w, jp.pallas_planes, k_dim=K_, n_dim=N,
        acc_len=acc, x_bits=x_bits, dcim_lsb=jc.dcim_lsb, adc_bits=adc,
        use_pallas=True, interpret=True)
    tp = Te.pack_quantized_cim_weights(torch.from_numpy(w),
                                       torch.from_numpy(one), tc)
    yt = tops.ccim_matmul_int_prepacked(
        torch.from_numpy(x), tp.kernel_w, tp.kernel_planes, k_dim=K_,
        n_dim=N, acc_len=acc, x_bits=x_bits, dcim_lsb=tc.dcim_lsb,
        adc_bits=adc)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("m,k,n", [(4, 64, 8), (33, 160, 20), (1, 2304, 3)])
def test_plain_equals_oracles_at_prototype_split(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int32)
    ref_t = torch_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w))), ref_t.numpy())
    p = Te.pack_quantized_cim_weights(torch.from_numpy(w),
                                      torch.ones((1, n)), Tc.DEFAULT_CONFIG)
    y = K.ccim_matmul_prepacked_plain(
        torch.from_numpy(x).to(torch.int8), p.kernel_w, p.kernel_planes)
    assert torch.equal(y, ref_t)


@pytest.mark.parametrize("m,k,n", [(5, 37, 11), (40, 64, 9)])
def test_unpacked_plain_equals_pallas_interpret(m, k, n):
    """Kernel 6's plain version against ccim_matmul_pallas in interpret
    mode (the reference's unpacked kernel, on its padded blocks), and the
    raw-weight wrapper against the reference's."""
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int32)
    kp = -(-k // 16) * 16
    bm, bn, bk = jops.pick_gemm_blocks(m, n, kp)
    mp, np_, kpp = (-(-m // bm) * bm, -(-n // bn) * bn, -(-kp // bk) * bk)
    xj = np.pad(x, ((0, mp - m), (0, kpp - k))).astype(np.int8)
    wj = np.pad(w, ((0, kpp - k), (0, np_ - n))).astype(np.int8)
    yj = jkernel.ccim_matmul_pallas(jnp.asarray(xj), jnp.asarray(wj), bm=bm,
                                    bn=bn, bk=bk, interpret=True)
    xt = torch.from_numpy(np.pad(x, ((0, 0), (0, kp - k)))).to(torch.int8)
    wt = torch.from_numpy(np.pad(w, ((0, kp - k), (0, 0)))).to(torch.int8)
    yt = K.ccim_matmul_unpacked_plain(xt, wt)
    assert yt.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(yj)[:m, :n], yt.numpy())
    np.testing.assert_array_equal(
        np.asarray(yj)[:m, :n],
        tops.ccim_matmul_int(torch.from_numpy(x), torch.from_numpy(w)).numpy())


def test_weight_layout_pads_only_whole_chunks():
    for k in (2304, 3072, 5760):                  # minicpm-2b: no padding
        for acc in (8, 16, 32, 64):
            assert tops.weight_layout(k, 9216, acc) == (k, 9216)
    assert tops.weight_layout(100, 7, 8) == (112, 7)
    assert tops.weight_layout(100, 7, 64) == (128, 7)


def test_cpu_tensors_take_the_plain_version():
    p = Te.pack_cim_weights(torch.randn(48, 8))
    x = torch.randint(-127, 128, (2, 48), dtype=torch.int32)
    K.reset_launch_counts()
    y = tops.ccim_matmul_int_prepacked(x, p.kernel_w, p.kernel_planes,
                                       k_dim=48, n_dim=8)
    assert y.shape == (2, 8) and y.dtype == torch.int32
    assert K.ccim_matmul_prepacked_skinny_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.ccim_matmul_int_prepacked(x, p.kernel_w, p.kernel_planes,
                                       k_dim=48, n_dim=8, use_kernel=True)
    for wrapper in (K.ccim_matmul_prepacked_skinny_cuda,
                    K.ccim_matmul_prepacked_general_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(x.to(torch.int8), p.kernel_w, p.kernel_planes)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.ccim_matmul_unpacked_cuda(x.to(torch.int8), p.wq().to(torch.int8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.ccim_matmul_int(x, p.wq(), use_kernel=True)
    assert K.ccim_matmul_unpacked_cuda.launches == 0


# kernels/build.py's library name -> the Pallas function its source ports
PALLAS = {"skinny": "ccim_matmul_prepacked_skinny_pallas",
          "general": "ccim_matmul_prepacked_pallas",
          "unpacked": "ccim_matmul_pallas",
          "complex_skinny": "ccim_complex_matmul_prepacked_skinny_pallas",
          "complex_general": "ccim_complex_matmul_prepacked_pallas",
          "complex_unpacked": "ccim_complex_matmul_pallas",
          "paged_attn": "paged_attention_pallas",
          "paged_attn_dh256": "paged_attention_pallas",
          "int8": "int8_matmul_pallas"}


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_kernel_sources_name_what_they_replace(name):
    """Every kernel source's header names the reference file and the
    Pallas function it replaces (which that file defines), what bounds
    it and its design."""
    src = build.SOURCES[name]
    text = (Path(build.__file__).parent / src).read_text()
    replaces = text[text.index("Replaces:"):]
    ref = f"src/repro/kernels/{src.split('/')[0]}/kernel.py"
    assert replaces.split(",")[0].endswith(ref) and PALLAS[name] in replaces
    repo = Path(build.__file__).resolve().parents[3]
    assert f"def {PALLAS[name]}(" in (repo / ref).read_text()
    assert "What bounds it" in text and "Design:" in text


def _x_plane(x: torch.Tensor, j: int) -> torch.Tensor:
    return torch.sign(x) * ((x.abs() >> j) & 1)


def _folded_convert(exact, dcim, lsb_shift: int, adc_half: int):
    """The general kernel's conversion, ints in, ints out: dcim + code of
    a chunk from its exact and DCIM sums, as the kernel computes it --
    the MMA chains seeded with lsb/2 and -adc_half, then
    clamp((exact + lsb/2) >> s, dcim - h, dcim + h - 1), which equals
    dcim + clamp(floor((exact - lsb dcim + lsb/2) / lsb), -h, h - 1)."""
    ex = exact + ((1 << lsb_shift) >> 1)
    dc = dcim - adc_half
    return torch.minimum(torch.maximum(ex >> lsb_shift, dc),
                         dc + 2 * adc_half - 1)


@pytest.mark.parametrize("k_split", [64, 192])
@pytest.mark.parametrize("acc", [8, 16, 32, 64])
def test_general_kernel_arithmetic_equals_fast_gemm_int(acc, k_split):
    """The general kernel's arithmetic in integers -- per split of K
    (``k_split`` bytes, whole 64-byte stages, as the kernel cuts them),
    per chunk, the folded conversion of the exact and DCIM sums, the
    splits added -- against the plain version (ccim.fast_gemm_int's float
    convert) at every design point (n_dcim 0-6 x ADC 7/8/9 b at this
    acc_len), with a last split shorter than the others (but where each
    split is one 64-byte chunk)."""
    rng = np.random.default_rng(acc + k_split)
    m, k, n = 5, 200, 24
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)))
    for nd in range(7):
        for adc in (7, 8, 9):
            cfg = Tc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
            p = Te.pack_quantized_cim_weights(w, torch.ones((1, n)), cfg)
            x_bits = tuple(Tc._dcim_by_j(cfg))
            planes = p.kernel_planes[:len(x_bits)]
            kp = p.kernel_w.shape[1]
            x = torch.from_numpy(rng.integers(-127, 128, (m, kp))).to(
                torch.int8)
            meta = dict(acc_len=acc, x_bits=x_bits, dcim_lsb=cfg.dcim_lsb,
                        adc_half=cfg.adc_half_range)
            want = K.ccim_matmul_prepacked_plain(x, p.kernel_w, planes,
                                                 **meta)
            shift = cfg.dcim_lsb.bit_length() - 1
            ranges = [(k0, min(k0 + k_split, kp))
                      for k0 in range(0, kp, k_split)]
            assert len(ranges) > 1 and (kp % k_split or k_split == acc)
            got = torch.zeros((m, n), dtype=torch.int64)
            for k0, k1 in ranges:
                part = torch.zeros((m, n), dtype=torch.int64)
                for c0 in range(k0, k1, acc):
                    xs = x[:, c0:c0 + acc].long()
                    exact = xs @ p.kernel_w[:, c0:c0 + acc].long().t()
                    dcim = torch.zeros_like(exact)
                    for j, pl in zip(x_bits, planes):
                        dcim += _x_plane(xs, j) @ pl[:, c0:c0 + acc].long().t()
                    part += _folded_convert(exact, dcim, shift,
                                            cfg.adc_half_range)
                got += part << shift
            assert torch.equal(got.to(torch.int32), want), (nd, adc)


@pytest.mark.parametrize("warps", [4, 7, 11])
@pytest.mark.parametrize("acc", [8, 16, 32, 64])
def test_skinny_kernel_arithmetic_equals_plain(acc, warps):
    """The skinny kernel's arithmetic in integers: ``warps`` warps share
    the (16-column tile, 128-byte K stage) sequence, tile-major, evenly
    (warp g takes stages g T / W .. (g + 1) T / W - 1); each converts
    every chunk of its stages with the folded conversion and, where its
    share or a tile ends, adds its sums to out (a tile cut between warps
    gets several partial sums) -- against the plain version at every
    design point at this acc_len, M 5 and 17 (one and three token
    groups), with N and Kp ragged against the tile and the stage."""
    rng = np.random.default_rng(acc * 100 + warps)
    k, n = 600, 40
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)))
    for nd in range(7):
        for adc in (7, 8, 9):
            cfg = Tc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
            p = Te.pack_quantized_cim_weights(w, torch.ones((1, n)), cfg)
            x_bits = tuple(Tc._dcim_by_j(cfg))
            planes = p.kernel_planes[:len(x_bits)]
            kp = p.kernel_w.shape[1]
            ks_n, tiles = -(-kp // 128), -(-n // 16)
            T = tiles * ks_n
            assert T % warps and T > warps      # uneven, cut shares
            shift = cfg.dcim_lsb.bit_length() - 1
            for m in (5, 17):
                x = torch.from_numpy(rng.integers(-127, 128, (m, kp))).to(
                    torch.int8)
                meta = dict(acc_len=acc, x_bits=x_bits,
                            dcim_lsb=cfg.dcim_lsb,
                            adc_half=cfg.adc_half_range)
                want = K.ccim_matmul_prepacked_plain(x, p.kernel_w, planes,
                                                     **meta)
                got = torch.zeros((m, n), dtype=torch.int64)
                cuts = 0
                for g in range(warps):
                    part = torch.zeros((m, n), dtype=torch.int64)
                    l0, l1 = g * T // warps, (g + 1) * T // warps
                    for L in range(l0, l1):
                        j, k0 = L // ks_n, (L % ks_n) * 128
                        cols = slice(16 * j, min(16 * j + 16, n))
                        for c0 in range(k0, min(k0 + 128, kp), acc):
                            xs = x[:, c0:c0 + acc].long()
                            wc = p.kernel_w[cols, c0:c0 + acc].long()
                            dcim = sum((_x_plane(xs, jb)
                                        @ pl[cols, c0:c0 + acc].long().t()
                                        for jb, pl in zip(x_bits, planes)),
                                       torch.zeros((m, wc.shape[0]),
                                                   dtype=torch.int64))
                            part[:, cols] += _folded_convert(
                                xs @ wc.t(), dcim, shift,
                                cfg.adc_half_range)
                        if L + 1 == l1 or (L + 1) % ks_n == 0:
                            cuts += not (l0 <= j * ks_n
                                         and l1 >= (j + 1) * ks_n)
                            got[:, cols] += part[:, cols] << shift
                            part[:, cols] = 0
                assert cuts > 0
                assert torch.equal(got.to(torch.int32), want), (nd, adc, m)


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4 i) & 7 of the 8 bytes y:x."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        b = (v >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        out |= b << np.uint64(8 * i)
    return out.astype(np.uint32)


def _raw_fill_operands(w_raw: np.ndarray):
    """The unpacked kernel's raw fill, word for word (ccim_mma.cuh,
    RawFill): raw (Kp, N) int8 weights, N zero-padded to whole 4-byte
    words -> w, P6 and P5 as (N, Kp) int8.  Each 4 x 4 byte block is
    transposed with transpose4's byte permutes, then mag4 (sign-replicate
    mask), fold4 and plane4(., 6) run on the K-contiguous words."""
    kp, n = w_raw.shape
    w4 = np.pad(w_raw, ((0, 0), (0, -n % 4))).view(np.uint32)  # (Kp, N/4)
    r = [w4[i::4] for i in range(4)]            # r[i]: row 4 kq + i
    t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[2], r[3], 0x5140)
    t2, t3 = _byte_perm(r[0], r[1], 0x7362), _byte_perm(r[2], r[3], 0x7362)
    cols = [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]
    m32 = np.uint64(0xFFFFFFFF)
    u = lambda v: np.uint64(v)
    out = {"w": [], "p6": [], "p5": []}
    for x in cols:                              # (Kp/4, N/4): column c
        x = x.astype(np.uint64)
        s = sum(((x >> u(8 * i + 7)) & u(1)) * u(0xFF << (8 * i))
                for i in range(4))              # prmt sign-replicate
        mag = ((x ^ s) + (s & u(0x01010101))) & m32
        keep = s | u(0x01010101)
        m = (mag >> u(5)) & u(0x03030303)
        neg = ((u(0x80808080) - m) ^ u(0x80808080)) & m32
        p6 = (m ^ ((m ^ neg) & keep)) & m32
        p5 = (((mag >> u(6)) & u(0x01010101)) * u(0xFF)) & keep & m32
        for key, v in (("w", x), ("p6", p6), ("p5", p5)):
            out[key].append(v.astype(np.uint32))
    # words (kq, nq) of column c hold k = 4 kq..4 kq + 3 of n = 4 nq + c
    lay = lambda ws: np.stack(ws, 2).view(np.int8).reshape(
        kp // 4, -1, 4, 4).transpose(1, 2, 0, 3).reshape(-1, kp)[:n]
    return tuple(torch.from_numpy(np.ascontiguousarray(lay(out[key])))
                 for key in ("w", "p6", "p5"))


@pytest.mark.parametrize("k_split", [64, 192])
@pytest.mark.parametrize("k", [200, 256])
def test_unpacked_kernel_arithmetic_equals_plain(k, k_split):
    """The unpacked kernel's arithmetic in integers: the raw fill's
    transposed w and its P6, P5 folded per byte from raw (K, N) weights
    equal the pack's ``kernel_w`` and ``kernel_planes``; then per split
    of K (``k_split`` bytes), per 64-byte stage (zero past the split's
    end, as the last stage is filled), per chunk, the folded conversion
    of the exact and DCIM sums, the splits added, equals
    ``ccim_matmul_unpacked_plain``.  K 200 pads to Kp 208, not a multiple
    of the stage."""
    rng = np.random.default_rng(k + k_split)
    m, n, acc, shift, half = 5, 22, 16, 11, 64
    kp = -(-k // acc) * acc
    w = rng.integers(-127, 128, (k, n))
    w_raw = np.pad(w, ((0, kp - k), (0, 0))).astype(np.int8)
    fw, p6, p5 = _raw_fill_operands(w_raw)
    p = Te.pack_quantized_cim_weights(torch.from_numpy(w), torch.ones((1, n)))
    assert torch.equal(fw, p.kernel_w)
    assert torch.equal(torch.stack([p6, p5]), p.kernel_planes)

    x = torch.from_numpy(rng.integers(-127, 128, (m, kp))).to(torch.int8)
    want = K.ccim_matmul_unpacked_plain(x, torch.from_numpy(w_raw))
    ranges = [(k0, min(k0 + k_split, kp)) for k0 in range(0, kp, k_split)]
    assert len(ranges) > 1
    got = torch.zeros((m, n), dtype=torch.int64)
    for k0, k1 in ranges:
        span = -(-(k1 - k0) // 64) * 64      # whole stages, zero past k1
        xs = F.pad(x[:, k0:k1].long(), (0, span - (k1 - k0)))
        ops = [F.pad(v[:, k0:k1].long(), (0, span - (k1 - k0)))
               for v in (fw, p6, p5)]
        part = torch.zeros((m, n), dtype=torch.int64)
        for c0 in range(0, span, acc):
            xc = xs[:, c0:c0 + acc]
            exact = xc @ ops[0][:, c0:c0 + acc].t()
            dcim = (_x_plane(xc, 6) @ ops[1][:, c0:c0 + acc].t()
                    + _x_plane(xc, 5) @ ops[2][:, c0:c0 + acc].t())
            part += _folded_convert(exact, dcim, shift, half)
        got += part << shift
    assert torch.equal(got.to(torch.int32), want)


def _complex_kernel_arithmetic(xs, ops, k_split: int):
    """Kernel rows 5 and 7's arithmetic in integers (``ccim_mma.cuh`` with
    two sides), from x_re, x_im (M, Kp) and each side's (w, P6, P5) as
    (N, Kp): per split of K (``k_split`` bytes), per 64-byte stage (zero
    past the split's end), per chunk the four sub-MAC streams ac = (x_re,
    Re), bd = (x_im, Im), ad = (x_re, Im) and bc = (x_im, Re), each the
    folded conversion of its own exact and DCIM sums, combined as (cv_ac
    - cv_bd, cv_ad + cv_bc), shifted, the splits added mod 2^32.  Returns
    (y_re, y_im) int32."""
    acc, shift, half = 16, 11, 64
    m, kp = xs[0].shape
    n = ops[0][0].shape[0]
    ranges = [(k0, min(k0 + k_split, kp)) for k0 in range(0, kp, k_split)]
    assert len(ranges) > 1
    got = [torch.zeros((m, n), dtype=torch.int64) for _ in range(2)]
    for k0, k1 in ranges:
        span = -(-(k1 - k0) // 64) * 64      # whole stages, zero past k1
        fill = lambda v: F.pad(v[..., k0:k1].long(), (0, span - (k1 - k0)))
        x = [fill(v) for v in xs]
        sides = [tuple(fill(v) for v in side) for side in ops]
        part = [torch.zeros((m, n), dtype=torch.int64) for _ in range(2)]
        for c0 in range(0, span, acc):
            def cv(x_side, w_side):
                xc = x[x_side][:, c0:c0 + acc]
                w, p6, p5 = (v[:, c0:c0 + acc] for v in sides[w_side])
                dcim = _x_plane(xc, 6) @ p6.t() + _x_plane(xc, 5) @ p5.t()
                return _folded_convert(xc @ w.t(), dcim, shift, half)
            part[0] += cv(0, 0) - cv(1, 1)
            part[1] += cv(0, 1) + cv(1, 0)
        for o in range(2):
            got[o] = (got[o] + (part[o] << shift)) % 2 ** 32
    return tuple(torch.where(g >= 2 ** 31, g - 2 ** 32, g).to(torch.int32)
                 for g in got)


@pytest.mark.parametrize("k_split", [64, 192])
@pytest.mark.parametrize("m,n", [(5, 22), (40, 37)])
def test_complex_general_kernel_arithmetic_equals_plain(m, n, k_split):
    """Kernel row 5's arithmetic in integers (``_complex_kernel_arithmetic``
    on the two packs) equals ``ccim_complex_prepacked_plain``.  K 200 pads
    to Kp 208, not a multiple of the stage; N is ragged."""
    rng = np.random.default_rng(m * n + k_split)
    k = 200
    packs = [Te.pack_quantized_cim_weights(
        torch.from_numpy(rng.integers(-127, 128, (k, n))),
        torch.ones((1, n))) for _ in range(2)]
    kp = packs[0].kernel_w.shape[1]
    assert kp % 64
    xs = [torch.from_numpy(rng.integers(-127, 128, (m, kp))).to(torch.int8)
          for _ in range(2)]
    want = CK.ccim_complex_prepacked_plain(
        xs[0], xs[1], packs[0].kernel_w, packs[0].kernel_planes,
        packs[1].kernel_w, packs[1].kernel_planes)
    got = _complex_kernel_arithmetic(
        xs, [(p.kernel_w, *p.kernel_planes) for p in packs], k_split)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k_split", [64, 192])
@pytest.mark.parametrize("k", [200, 256])
def test_complex_unpacked_kernel_arithmetic_equals_plain(k, k_split):
    """Kernel row 7's arithmetic in integers: the raw fill of each side
    (``_raw_fill_operands``: the transposed w and its P6, P5 folded per
    byte from raw (K, N) weights) equals that side's pack, and the two-side
    arithmetic of ``_complex_kernel_arithmetic`` on those operands equals
    ``ccim_complex_unpacked_plain``.  K 200 pads to Kp 208, not a multiple
    of the stage; N 37 is ragged (rows not 16-byte aligned)."""
    rng = np.random.default_rng(k + k_split)
    m, n = 5, 37
    kp = -(-k // 16) * 16
    ws = [rng.integers(-127, 128, (k, n)) for _ in range(2)]
    raw = [torch.from_numpy(np.pad(w, ((0, kp - k), (0, 0))).astype(np.int8))
           for w in ws]
    ops = []
    for w, w_raw in zip(ws, raw):
        fw, p6, p5 = _raw_fill_operands(w_raw.numpy())
        p = Te.pack_quantized_cim_weights(torch.from_numpy(w),
                                          torch.ones((1, n)))
        assert torch.equal(fw, p.kernel_w)
        assert torch.equal(torch.stack([p6, p5]), p.kernel_planes)
        ops.append((fw, p6, p5))
    xs = [torch.from_numpy(rng.integers(-127, 128, (m, kp))).to(torch.int8)
          for _ in range(2)]
    want = CK.ccim_complex_unpacked_plain(xs[0], xs[1], raw[0], raw[1])
    got = _complex_kernel_arithmetic(xs, ops, k_split)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the paged-attention kernel's walk (kernels/paged_attn) ----------------


def _attended_entries(length, bs, n_tbl, window, is_local):
    """Table entries < n_tbl that hold a position the query attends,
    from the positions themselves."""
    q_pos = length - 1
    return sorted({p // bs for p in range(max(q_pos + 1, 0))
                   if not (is_local and window and q_pos - p >= window)
                   and p // bs < n_tbl})


@pytest.mark.parametrize("window,is_local", [(None, False), (7, True),
                                             (7, False), (40, True)])
@pytest.mark.parametrize("bs", [4, 5, 16])
def test_paged_splits_cover_the_attended_entries_once(bs, window, is_local):
    """Every split that has work walks at least one attended entry, and
    the splits of a row cover its attended entries exactly once, at every
    split count the kernel can be given, lengths on and off block and
    split boundaries."""
    n_tbl = 13
    for length in range(0, n_tbl * bs + 3):
        want = _attended_entries(length, bs, n_tbl, window, is_local)
        j_lo, n = PK.row_walk(length, bs, n_tbl, window, is_local)
        assert list(range(j_lo, j_lo + n)) == want
        for n_split in (1, 2, 3, 4, 7, 13, 20):
            ranges = PK.split_ranges(j_lo, n, n_split)
            assert len(ranges) == min(max(n, 1), n_split)
            walked = [j for lo, hi in ranges for j in range(lo, hi)]
            assert walked == want
            if n:
                assert all(hi > lo for lo, hi in ranges)


def test_paged_split_counts():
    """The split counts at minicpm-2b's decode shape (B 8, 48 kv heads, G
    1) for L 96, 1024 and 4096 at block size 16, as PERF.md states them,
    and at phase 13's head dim 256 cases (gemma2-9b: B 8, 8 kv heads, G 2;
    paligemma-3b: B 8, 1 kv head, G 8; L 96 and 1,024), and each rule's
    bounds elsewhere: at Dh 256 one entry a split at least, at most
    WIDE_BLOCKS_PER_SM blocks per SM and WIDE_MAX_SPLITS splits unless a
    walk is longer than SPLIT_MAX_ENTRIES entries a split."""
    counts = {L: PK.paged_split(8, 48, 1, -(-L // 16))
              for L in (96, 1024, 4096)}
    assert counts == {96: 1, 1024: 1, 4096: 4}
    wide = {(Hkv, L): PK.paged_split(8, Hkv, G, -(-L // 16), Dh=256)
            for Hkv, G in ((8, 2), (1, 8)) for L in (96, 1024)}
    assert wide == {(8, 96): 6, (8, 1024): 8, (1, 96): 6, (1, 1024): 16}
    for B, Hkv, G in ((1, 48, 1), (8, 48, 1), (1, 8, 8), (2, 2, 16)):
        for n in range(1, 600, 7):
            s = PK.paged_split(B, Hkv, G, n)
            assert s >= 1
            assert s == 1 or n // s >= PK.SPLIT_MIN_ENTRIES // 2
            if n <= PK.SPLIT_MIN_ENTRIES:
                assert s == 1
            s = PK.paged_split(B, Hkv, G, n, Dh=256)
            assert 1 <= s <= n
            assert ((B * Hkv * s <= PK.WIDE_BLOCKS_PER_SM * PK.H100_SMS
                     and s <= PK.WIDE_MAX_SPLITS)
                    or s == -(-n // PK.SPLIT_MAX_ENTRIES) or s == 1)
            assert -(-n // s) <= PK.SPLIT_MAX_ENTRIES


def _wide_walk_model(q, kp, vp, table, lengths, is_local, softcap, window,
                     n_split):
    """The Dh 256 kernel's walk (``paged_attn_dh256.cu``) in float32: per
    split, its attended positions in tiles of 16 through the ring, all G
    query heads of a kv head in one tile (q scaled in bf16), an online
    softmax per head over the tiles, P.V with p as two bf16 terms (p_hi +
    p_lo), and the splits merged in split order."""
    B, Hq, Dh = q.shape
    nb, bs, Hkv, _ = kp.shape
    G = Hq // Hkv
    bf = lambda t: t.to(torch.bfloat16).float()
    qs = bf(q.float() * float(np.float32(Dh ** -0.5))).view(B, Hkv, G, Dh)
    kf, vf = kp.float(), vp.float()
    out = torch.zeros(B, Hkv, G, Dh)
    for b in range(B):
        q_pos = int(lengths[b]) - 1
        local = bool(is_local and window)
        j_lo, n = PK.row_walk(q_pos + 1, bs, table.shape[1], window,
                              is_local)
        splits = []
        for lo, hi in PK.split_ranges(j_lo, n, n_split):
            p_lo = max(lo * bs, q_pos - window + 1 if local else 0)
            p_hi = min(hi * bs, q_pos + 1)
            m = torch.full((Hkv, G), -1e30)
            l, acc = torch.zeros(Hkv, G), torch.zeros(Hkv, G, Dh)
            for p0 in range(p_lo, p_hi, 16):
                pos = range(p0, min(p0 + 16, p_hi))
                blk = [min(max(int(table[b, p // bs]), 0), nb - 1)
                       for p in pos]
                k = torch.stack([kf[c, p % bs] for c, p in zip(blk, pos)], 1)
                v = torch.stack([vf[c, p % bs] for c, p in zip(blk, pos)], 1)
                s = torch.einsum("hgd,htd->hgt", qs[b], k)
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                ph = bf(p)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "hgt,htd->hgd", ph + bf(p - ph), v)
                m = mx
            splits.append((m, l, acc))
        mm = torch.stack([s[0] for s in splits]).amax(0)
        w = [torch.exp(s[0] - mm) for s in splits]
        ls = sum(s[1] * wi for s, wi in zip(splits, w))
        a = sum(s[2] * wi[..., None] for s, wi in zip(splits, w))
        out[b] = a / torch.clamp(ls, min=1e-30)[..., None]
    return out.reshape(B, Hq, Dh).to(torch.bfloat16)


def _walk_model(q, kp, vp, table, lengths, is_local, softcap, window,
                n_split):
    """The CUDA kernel's walk in float32: at Dh 64 and 128, per split,
    warp w folds chunks w, w + 4, ... (4 warp loads of 32 / (Dh / 8) rows
    each), every row group of a warp its own online softmax; row groups
    merge pairwise as the shuffles pair them, warps in order, splits in
    order.  At Dh 256 the tensor-core walk (``_wide_walk_model``)."""
    B, Hq, Dh = q.shape
    if Dh == PK.WIDE_DH:
        return _wide_walk_model(q, kp, vp, table, lengths, is_local, softcap,
                                window, n_split)
    nb, bs, Hkv, _ = kp.shape
    G = Hq // Hkv
    rp = 32 // (Dh // 8)
    chunk = 4 * rp
    cpe = -(-bs // chunk)
    qs = q.float() * float(np.float32(Dh ** -0.5))
    kf, vf = kp.float(), vp.float()
    neg = torch.full((Hq,), -1e30)

    def merge(states):
        m = torch.stack([s[0] for s in states]).amax(0)
        w = [torch.exp(s[0] - m) for s in states]
        return (m, sum(s[1] * wi for s, wi in zip(states, w)),
                sum(s[2] * wi[:, None] for s, wi in zip(states, w)))

    out = torch.zeros(B, Hq, Dh)
    for b in range(B):
        q_pos = int(lengths[b]) - 1
        j_lo, n = PK.row_walk(q_pos + 1, bs, table.shape[1], window,
                              is_local)
        splits = []
        for lo, hi in PK.split_ranges(j_lo, n, n_split):
            warps = []
            for w in range(4):
                groups = []
                for r in range(rp):
                    m, l, acc = neg.clone(), torch.zeros(Hq), torch.zeros(
                        Hq, Dh)
                    for c in range(w, (hi - lo) * cpe, 4):
                        j = lo + c // cpe
                        blk = min(max(int(table[b, j]), 0), nb - 1)
                        ts = [(c % cpe) * chunk + p * rp + r
                              for p in range(4)]
                        ts = [t for t in ts if t < bs and j * bs + t <= q_pos
                              and not (is_local and window
                                       and q_pos - j * bs - t >= window)]
                        if not ts:
                            continue
                        s = torch.stack([
                            (qs[b].view(Hkv, G, Dh)
                             * kf[blk, t][:, None, :]).sum(-1).reshape(Hq)
                            for t in ts])
                        if softcap:
                            s = softcap * torch.tanh(s / softcap)
                        mx = torch.maximum(m, s.amax(0))
                        corr = torch.exp(m - mx)
                        m, l, acc = mx, l * corr, acc * corr[:, None]
                        for i, t in enumerate(ts):
                            p = torch.exp(s[i] - m)
                            l = l + p
                            acc = acc + p[:, None] * vf[blk, t].repeat_interleave(
                                G, 0)
                    groups.append((m, l, acc))
                while len(groups) > 1:       # r with r ^ 1, then r ^ 2
                    groups = [merge(groups[i:i + 2])
                              for i in range(0, len(groups), 2)]
                warps.append(groups[0])
            splits.append(merge(warps))
        m, l, acc = merge(splits)
        out[b] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("Dh,G,bs,n_split", [(64, 1, 16, 1), (64, 1, 16, 3),
                                             (64, 4, 5, 2), (128, 2, 32, 4),
                                             (128, 1, 8, 7), (256, 1, 16, 2),
                                             (256, 8, 16, 1), (256, 16, 16, 3),
                                             (256, 2, 16, 4)])
@pytest.mark.parametrize("softcap,window,is_local", [(None, None, False),
                                                     (30.0, 7, True)])
def test_paged_kernel_walk_matches_plain(Dh, G, bs, n_split, softcap, window,
                                         is_local):
    """The kernel's chunking, masks, per-row-group and per-warp states and
    split merges (at Dh 256: tiles through the ring, all G heads in one
    tile, p as p_hi + p_lo, splits in order), modelled in float32, against
    the plain version to the card test's tolerance (rtol 2^-7, atol 2^-7
    max|v|: the plain version rounds p to bf16 before P.V).  The last
    row's table is all trash block; lengths fall on and off block
    boundaries."""
    rng = np.random.default_rng(Dh + G + bs + n_split)
    B, Hkv, n_tbl = 4, 2, 9
    nb = B * n_tbl + 1
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16)
    q, kp, vp = bf(B, Hkv * G, Dh) * 2, bf(nb, bs, Hkv, Dh), bf(nb, bs, Hkv,
                                                               Dh)
    table = torch.from_numpy(rng.permutation(np.arange(1, nb))[:B * n_tbl]
                             .reshape(B, n_tbl).astype(np.int32))
    table[-1] = 0
    lengths = torch.tensor([n_tbl * bs, 3 * bs, 2 * bs + 1, 5 * bs - 1],
                           dtype=torch.int32)
    got = _walk_model(q, kp, vp, table, lengths, is_local, softcap, window,
                      n_split)
    want = PR.paged_attention_ref(q, kp, vp, table, lengths, softcap=softcap,
                                  window=window, is_local=is_local)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7 * float(vp.float().abs().max()))
