"""The port's FFT stage 1 (K6, sdr_receiver_dvb_t2_tpu_torch/ops/
fft_stage1.py) and its matmul FFT (ops/mxu_fft.py) against the JAX side.

- K6's plain version against the TPU kernel `s1_kernel` of
  tools/fft_microbench.py.  That kernel sits inside the tool's `main()`
  and cannot be imported, so its body is restated here line for line and
  run through `pl.pallas_call(interpret=True)`.  Tolerance:
  `fft_stage1.compare` (one bf16 ulp where the f32 row sums are taken in
  another order, fewer than 1% of elements differing at all).
- What the CUDA kernel gets from Python, on the CPU: `pack_tables` unpacks
  to the JAX tool's bf16 W1^T and twiddle for every n, and an emulation of
  the kernel's schedule (persistent CTAs over work items, W1^T bands, ring
  chunks, 16-deep products with the negated Wi, the twiddle epilogue in
  the accumulators' order, the swizzled output tile) is held to the
  interpret-mode `s1_kernel` within `compare`.  The emulation is Python
  written beside `csrc/fft_stage1.cu`, not the `.cu` itself: only the
  `cuda`-marked test on the card runs the kernel.
- `mxu_fft` against the JAX `ops/mxu_fft.py`: tables exact; f32 outputs
  within 1e-4 of the spectrum's RMS (both are f32 products of the same
  tables; JAX runs them at Precision.HIGHEST here); the bf16 pipe within
  the pipe's own error, 2e-2 of the RMS (its input and every intermediate
  round to bf16, 2^-9 relative each, through two 32-term stages), of the
  JAX f32 spectrum and of the true f64 spectrum.  The two stages'
  products are held to the JAX package's einsums ("fsnm,nk->fskm",
  "fskm,ml->lksf", at Precision.HIGHEST on operands widened to f32, as a
  bf16 product with f32 accumulation computes them): f32 within the f32
  sum's rounding, bf16 within one bf16 ulp of each rounding.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdr_receiver_dvb_t2_tpu.ops import mxu_fft as jfft
from sdr_receiver_dvb_t2_tpu_torch.ops import fft_stage1, mxu_fft
from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench

CU = Path(fft_stage1.__file__).resolve().parents[1] / "csrc" / "fft_stage1.cu"

torch.set_num_threads(1)

N = 1024
F, S = 2, 3


def _planes(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(F, S, n)).astype(np.float32),
            rng.normal(size=(F, S, n)).astype(np.float32))


def _rms(x):
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def _jax_s1(xr, xi, n):
    """Stage 1 + twiddle through the tool's kernel body in interpret
    mode: (F, S, n) f32 planes -> bf16-valued f32 (b_r, b_i)."""
    n1, n2 = jfft._FACTORS[n]
    w1, _, tw = jfft._tables(n)
    dt = jnp.bfloat16
    w1rT = jnp.asarray(np.ascontiguousarray(w1.real.T), dtype=dt)
    w1iT = jnp.asarray(np.ascontiguousarray(w1.imag.T), dtype=dt)
    twr = jnp.asarray(np.ascontiguousarray(tw.real), dtype=dt)
    twi = jnp.asarray(np.ascontiguousarray(tw.imag), dtype=dt)

    def s1_kernel(yr_ref, yi_ref, w1r_ref, w1i_ref, twr_ref, twi_ref,
                  br_ref, bi_ref):
        yr = yr_ref[0, 0]
        yi = yi_ref[0, 0]
        wr = w1r_ref[...]
        wi = w1i_ref[...]
        ar = (jnp.dot(wr, yr, preferred_element_type=jnp.float32)
              - jnp.dot(wi, yi, preferred_element_type=jnp.float32))
        ai = (jnp.dot(wr, yi, preferred_element_type=jnp.float32)
              + jnp.dot(wi, yr, preferred_element_type=jnp.float32))
        twr_ = twr_ref[...].astype(jnp.float32)
        twi_ = twi_ref[...].astype(jnp.float32)
        br_ref[0, 0] = (ar * twr_ - ai * twi_).astype(br_ref.dtype)
        bi_ref[0, 0] = (ar * twi_ + ai * twr_).astype(bi_ref.dtype)

    f, s = xr.shape[:2]
    yr = jnp.asarray(xr).astype(dt).reshape(f, s, n1, n2)
    yi = jnp.asarray(xi).astype(dt).reshape(f, s, n1, n2)
    yspec = pl.BlockSpec((1, 1, n1, n2), lambda i, j: (i, j, 0, 0))
    wspec = pl.BlockSpec((n1, n1), lambda i, j: (0, 0))
    tspec = pl.BlockSpec((n1, n2), lambda i, j: (0, 0))
    br, bi = pl.pallas_call(
        s1_kernel, grid=(f, s),
        in_specs=[yspec, yspec, wspec, wspec, tspec, tspec],
        out_specs=[yspec, yspec],
        out_shape=(jax.ShapeDtypeStruct((f, s, n1, n2), dt),
                   jax.ShapeDtypeStruct((f, s, n1, n2), dt)),
        interpret=True)(yr, yi, w1rT, w1iT, twr, twi)
    return (np.asarray(br.astype(jnp.float32)),
            np.asarray(bi.astype(jnp.float32)))


def test_k6_plain_equals_pallas_kernel():
    xr, xi = _planes(1)
    ref_r, ref_i = _jax_s1(xr, xi, N)
    stage = fft_stage1.Stage1(N)
    br, bi = stage(torch.from_numpy(xr), torch.from_numpy(xi))
    assert br.dtype == bi.dtype == torch.bfloat16
    assert br.shape == bi.shape == (F, S, 32, 32)
    for got, ref in ((br, ref_r), (bi, ref_i)):
        res = fft_stage1.compare(got, torch.from_numpy(ref.copy()))
        assert res["ok"], res


def test_k6_tables_are_the_jax_tool_s():
    """W1^T and the twiddle in bf16, as the tool casts them."""
    w1, _, tw = jfft._tables(N)
    w1r_t, w1i_t, twr, twi = fft_stage1.Stage1(N).tables("cpu")
    for mine, ref in ((w1r_t, w1.real.T), (w1i_t, w1.imag.T),
                      (twr, tw.real), (twi, tw.imag)):
        want = np.asarray(jnp.asarray(np.ascontiguousarray(ref),
                                      dtype=jnp.bfloat16
                                      ).astype(jnp.float32))
        np.testing.assert_array_equal(mine.float().numpy(), want)


def test_k6_does_not_round_a_before_the_twiddle():
    """`fft_carrier_major_planar` rounds a_r, a_i to bf16 before the
    twiddle; K6 rounds once, after it.  On the same input the two stage-1
    results differ, and K6's is the closer to the f64 value."""
    xr, xi = _planes(2)
    stage = fft_stage1.Stage1(N)
    yr, yi = stage._input(torch.from_numpy(xr), torch.from_numpy(xi))
    w1r_t, w1i_t, twr, twi = stage.tables("cpu")
    br, bi = fft_stage1.stage1_plain(yr, yi, w1r_t, w1i_t, twr, twi)
    wr, wi, tr, ti = (t.float() for t in (w1r_t, w1i_t, twr, twi))
    ar = (wr @ yr.float() - wi @ yi.float()).bfloat16().float()
    ai = (wr @ yi.float() + wi @ yr.float()).bfloat16().float()
    rounded = (ar * tr - ai * ti).bfloat16()
    assert not torch.equal(rounded, br)
    a64 = (wr.double() + 1j * wi.double()) @ (yr.double() + 1j * yi.double())
    b64 = (a64 * (tr.double() + 1j * ti.double())).real
    assert (br.double() - b64).abs().mean() \
        < (rounded.double() - b64).abs().mean()


def test_k6_stage1_plus_stage2_is_the_fft():
    xr, xi = _planes(3)
    stage = fft_stage1.Stage1(N)
    out_r, out_i = mxu_fft.stage2_carrier_major(
        *stage(torch.from_numpy(xr), torch.from_numpy(xi)), N)
    assert out_r.shape == (N, S, F) and out_r.dtype == torch.bfloat16
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1
                     ).transpose(2, 1, 0)
    got = out_r.double().numpy() + 1j * out_i.double().numpy()
    assert _rms(got - ref) < 2e-2 * _rms(ref)


def test_k6_wrapper_checks_its_input():
    stage = fft_stage1.Stage1(N)
    x = torch.zeros((F, S, N))
    with pytest.raises(ValueError):                 # CPU tensors: no kernel
        stage.kernel(x, x)
    with pytest.raises(ValueError):
        stage(torch.zeros((F, S, N // 2)), torch.zeros((F, S, N // 2)))
    assert fft_stage1.fft_stage1_cuda.launches == 0


@pytest.mark.parametrize("n", sorted(jfft._FACTORS))
def test_tables_equal_jax(n):
    assert mxu_fft._FACTORS[n] == jfft._FACTORS[n]
    if n > 4096:
        return                       # the same code; keep the arrays small
    for mine, ref in zip(mxu_fft._tables(n), jfft._tables(n)):
        assert mine.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(mine, ref)


def test_fft_f32_equals_jax():
    xr, xi = _planes(4)
    hi = jax.lax.Precision.HIGHEST
    ref_r, ref_i = jfft.fft_stages_planar(jnp.asarray(xr), jnp.asarray(xi),
                                          N, precision=hi)
    got_r, got_i = mxu_fft.fft_stages_planar(torch.from_numpy(xr),
                                             torch.from_numpy(xi), N)
    assert got_r.shape == (F, S, 32, 32) and got_r.dtype == torch.float32
    scale = _rms(np.asarray(ref_r))
    assert np.abs(got_r.numpy() - np.asarray(ref_r)).max() < 1e-4 * scale
    assert np.abs(got_i.numpy() - np.asarray(ref_i)).max() < 1e-4 * scale
    # carrier-major and the complex drop-in
    cm_r, cm_i = jfft.fft_carrier_major_planar(
        jnp.asarray(xr), jnp.asarray(xi), N, precision=hi)
    tm_r, tm_i = mxu_fft.fft_carrier_major_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), N)
    assert tm_r.shape == (N, S, F)
    assert np.abs(tm_r.numpy() - np.asarray(cm_r)).max() < 1e-4 * scale
    assert np.abs(tm_i.numpy() - np.asarray(cm_i)).max() < 1e-4 * scale
    z = torch.from_numpy(xr + 1j * xi)
    zf = mxu_fft.fft(z)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jfft.fft(
        jnp.asarray(xr + 1j * xi), precision=hi)), atol=1e-4 * scale)
    np.testing.assert_allclose(zf.numpy(), np.fft.fft(xr + 1j * xi),
                               atol=1e-4 * scale)
    # an unsupported length takes the library FFT
    np.testing.assert_allclose(mxu_fft.fft(z[..., :100]).numpy(),
                               np.fft.fft((xr + 1j * xi)[..., :100]),
                               atol=1e-4 * scale)


def test_fft_bf16_pipe_within_its_error():
    """The JAX bf16 pipe itself cannot run here (XLA's CPU backend has no
    bf16 x bf16 -> f32 dot), so the port's bf16 pipe is held to the JAX
    f32 spectrum and to the f64 truth."""
    xr, xi = _planes(5)
    ref_r, ref_i = jfft.fft_carrier_major_planar(
        jnp.asarray(xr), jnp.asarray(xi), N,
        precision=jax.lax.Precision.HIGHEST)
    got_r, got_i = mxu_fft.fft_carrier_major_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), N, dtype=torch.bfloat16)
    assert got_r.dtype == torch.bfloat16 and got_r.shape == (N, S, F)
    ref = np.asarray(ref_r) + 1j * np.asarray(ref_i)
    got = got_r.float().numpy() + 1j * got_i.float().numpy()
    truth = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1
                       ).transpose(2, 1, 0)
    assert _rms(got - ref) < 2e-2 * _rms(truth)
    assert _rms(got - truth) < 2e-2 * _rms(truth)
    assert _rms(got - truth) > 1e-4 * _rms(truth)     # it is the bf16 pipe


def test_fft_microbench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fft_microbench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_fft_microbench_library_route_is_stage1():
    """The tool's library yardstick (bf16 torch.matmul, a rounded before
    the twiddle) computes K6's function up to that extra rounding."""
    xr, xi = _planes(7)
    stage = fft_stage1.Stage1(N)
    yr, yi = stage._input(torch.from_numpy(xr), torch.from_numpy(xi))
    tabs = stage.tables("cpu")
    lib_r, lib_i = fft_microbench.stage1_matmul_bf16(yr, yi, *tabs)
    ref_r, ref_i = fft_stage1.stage1_plain(yr, yi, *tabs)
    assert lib_r.dtype == torch.bfloat16
    scale = float(ref_r.float().abs().max())
    assert float((lib_r.float() - ref_r.float()).abs().max()) < 2e-2 * scale
    assert float((lib_i.float() - ref_i.float()).abs().max()) < 2e-2 * scale


def _jax_bf16(a):
    """The JAX tool's cast of a table to bf16, back in f32 numpy."""
    return np.asarray(jnp.asarray(np.ascontiguousarray(a), dtype=jnp.bfloat16
                                  ).astype(jnp.float32))


def _swizzle(lin, sw):
    """The TMA box swizzle of a byte offset in rows of `sw` bytes (128 or
    64), as `wgmma` and TMA apply it: the 16-byte chunk index XOR the row
    bits above it (an involution)."""
    return lin ^ (((lin >> 7) & (sw // 16 - 1)) << 4)


def _unpack_w(w):
    """`pack_tables`' W blocks -> (2 planes, bands*BAND, chunks*KCH) f32,
    each block read through the hardware's 128-byte swizzle."""
    bands, _, chunks, _ = w.shape
    m = torch.arange(fft_stage1.BAND)[:, None]
    k = torch.arange(fft_stage1.KCH)[None, :]
    where = _swizzle(m * 2 * fft_stage1.KCH + 2 * k, 128) // 2
    blocks = w[..., where.flatten()].float()
    return blocks.reshape(bands, 2, chunks, fft_stage1.BAND, fft_stage1.KCH
                          ).permute(1, 0, 3, 2, 4).reshape(
        2, bands * fft_stage1.BAND, chunks * fft_stage1.KCH)


@pytest.mark.parametrize("n", sorted(jfft._FACTORS))
def test_k6_pack_tables_unpack_to_the_jax_tool_s(n):
    """The kernel's packed W1^T and twiddle hold exactly the JAX tool's
    bf16 casts (`tools/fft_microbench.py:144-145`, `:104-105`), zeros in
    the padding (n1 = 32 pads its band to 64 rows and 64 columns)."""
    n1, n2 = jfft._FACTORS[n]
    w1, _, tw = jfft._tables(n)
    w, twp = fft_stage1.pack_tables(n)
    assert w.dtype == twp.dtype == torch.bfloat16
    assert (tuple(w.shape), tuple(twp.shape)) == fft_stage1.packed_shapes(
        n1, n2)
    full = _unpack_w(w).numpy()
    for plane, ref in enumerate((w1.real.T, w1.imag.T)):
        np.testing.assert_array_equal(full[plane, :n1, :n1], _jax_bf16(ref))
    assert not full[:, n1:].any() and not full[:, :, n1:].any()
    rows, cols = fft_stage1.twiddle_index(n1, n2)
    assert int(rows.max()) == max(n1, fft_stage1.BAND) - 1
    plane = torch.arange(8) % 4 // 2
    ref = np.zeros((2, max(n1, fft_stage1.BAND), n2), np.float32)
    ref[0, :n1], ref[1, :n1] = _jax_bf16(tw.real), _jax_bf16(tw.imag)
    want = ref[plane.expand_as(rows).numpy(), rows.numpy(), cols.numpy()]
    np.testing.assert_array_equal(twp.float().numpy(), want)
    # every (row, column) of the twiddle appears once in each plane
    counts = np.zeros((2, max(n1, fft_stage1.BAND), n2), int)
    np.add.at(counts, (plane.expand_as(rows).numpy(), rows.numpy(),
                       cols.numpy()), 1)
    assert (counts == 1).all()


def _emulate_k6(yr, yi, n, sms):
    """The kernel's schedule on the CPU, in f32, on bf16 y (n_sym, n1, n2)
    and the tables of `pack_tables`; `sms` CTAs at most (as `make_plan`
    sizes the persistent grid).  -> bf16 (b_r, b_i) and the number of
    times each (symbol, column tile, band) was computed."""
    band_rows, kch = fft_stage1.BAND, fft_stage1.KCH
    n1, n2 = mxu_fft._FACTORS[n]
    w, twp = fft_stage1.pack_tables(n)
    bands = max(n1 // band_rows, 1)
    blocks = _unpack_w(w).reshape(2, bands, band_rows, -1)
    bn = min(n2, 64)
    sw = 2 * bn                                  # bytes of a box row
    wgs = 2 if n1 >= 2 * band_rows else 1        # consumer warpgroups
    bk = min(n1, kch)
    groups = bands // wgs
    n_sym = yr.shape[0]
    tiles = n2 // bn
    items = n_sym * tiles
    ctas = min(items, sms // groups) * groups
    rows = min(n1, band_rows)
    # accumulator (row, column) of register 4 j + 2 h + q of thread t
    t = torch.arange(128)[:, None, None, None]
    j = torch.arange(bn // 8)[None, :, None, None]
    h = torch.arange(2)[None, None, :, None]
    q = torch.arange(2)[None, None, None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * h
    col = 8 * j + 2 * (t % 4) + q
    e = 4 * h + q                                # tr's place in the uint4
    br = torch.zeros(n_sym, n1, n2, dtype=torch.bfloat16)
    bi = torch.zeros_like(br)
    done = {}
    for cta in range(ctas):
        g, first, step = cta % groups, cta // groups, ctas // groups
        for item in range(first, items, step):
            sym, col0 = item // tiles, (item % tiles) * bn
            for wg in range(wgs):
                band = g * wgs + wg
                acc_r = torch.zeros(band_rows, bn)
                acc_i = torch.zeros(band_rows, bn)
                for c in range(n1 // bk):
                    y_r = yr[sym, c * bk:(c + 1) * bk, col0:col0 + bn].float()
                    y_i = yi[sym, c * bk:(c + 1) * bk, col0:col0 + bn].float()
                    for ks in range(bk // 16):
                        k = slice(c * kch + 16 * ks, c * kch + 16 * ks + 16)
                        a_r, a_i = blocks[0, band, :, k], blocks[1, band, :, k]
                        b_r = y_r[16 * ks:16 * ks + 16]
                        b_i = y_i[16 * ks:16 * ks + 16]
                        acc_r = acc_r + a_r @ b_r
                        acc_r = acc_r + (-a_i) @ b_i
                        acc_i = acc_i + a_r @ b_i
                        acc_i = acc_i + a_i @ b_r
                # the epilogue, thread by thread, into the swizzled tile
                tv = twp[band, col0 // 8:col0 // 8 + bn // 8].permute(1, 0, 2)
                tv = tv.float()[:, :, None, None, :].expand(
                    128, bn // 8, 2, 2, 8)
                tr = torch.gather(tv, 4, e.expand(128, bn // 8, 2, 2)[
                    ..., None])[..., 0]
                ti = torch.gather(tv, 4, (e + 2).expand(128, bn // 8, 2, 2)[
                    ..., None])[..., 0]
                ar, ai = acc_r[row, col], acc_i[row, col]
                out = [(ar * tr - ai * ti).to(torch.bfloat16),
                       (ar * ti + ai * tr).to(torch.bfloat16)]
                keep = (row < rows).expand_as(ar)
                off = _swizzle(row * sw + col * 2, sw).expand_as(ar)
                for plane, dst in zip(out, (br, bi)):
                    tile = torch.zeros(rows * sw // 2, dtype=torch.bfloat16)
                    tile[off[keep] // 2] = plane[keep]
                    lin = (torch.arange(rows)[:, None] * sw
                           + torch.arange(bn)[None, :] * 2)
                    dst[sym, band * band_rows:band * band_rows + rows,
                        col0:col0 + bn] = tile[_swizzle(lin, sw) // 2]
                key = (sym, col0, band)
                done[key] = done.get(key, 0) + 1
    return br, bi, done


@pytest.mark.parametrize("n,sms", [(1024, 132), (8192, 5), (32768, 7)])
def test_k6_schedule_emulation_matches_the_pallas_kernel(n, sms):
    """The kernel's schedule, emulated on the CPU, against the TPU kernel
    in interpret mode; a small grid leaves the last round ragged."""
    n1, n2 = mxu_fft._FACTORS[n]
    rng = np.random.default_rng(11)
    f, s = 1, 5
    xr = rng.normal(size=(f, s, n)).astype(np.float32)
    xi = rng.normal(size=(f, s, n)).astype(np.float32)
    ref_r, ref_i = _jax_s1(xr, xi, n)
    yr = torch.from_numpy(xr).to(torch.bfloat16).reshape(f * s, n1, n2)
    yi = torch.from_numpy(xi).to(torch.bfloat16).reshape(f * s, n1, n2)
    br, bi, done = _emulate_k6(yr, yi, n, sms)
    bn = min(n2, 64)
    assert sorted(done) == sorted(
        (sym, col0, band) for sym in range(f * s)
        for col0 in range(0, n2, bn) for band in range(max(n1 // 64, 1)))
    assert set(done.values()) == {1}
    for got, ref in ((br, ref_r), (bi, ref_i)):
        res = fft_stage1.compare(got.reshape(f, s, n1, n2),
                                 torch.from_numpy(ref.copy()))
        assert res["ok"], res


def test_k6_source_constants_and_variants():
    """The constants `pack_tables` shares with the kernel, read out of the
    `.cu`; its one build switch is the profiling build that
    `fft_microbench.k6_profile` asks for, with the counters it reads."""
    src = CU.read_text()
    for name in ("BAND", "KCH"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(fft_stage1, name), name
    assert set(re.findall(r"#ifn?def (\w+)", src)) == {"K6_PROFILE"}
    tool = Path(fft_microbench.__file__).read_text()
    assert '"-DK6_PROFILE"' in tool
    n_prof = int(re.search(r"g_prof\[(\d+)\];", src).group(1))
    assert n_prof == len(fft_microbench.K6_PARTS) + 2   # + run, items
    for fn in ("fft_stage1(", "fft_stage1_supported(", "fft_stage1_plan(",
               "fft_stage1_error_string(", "fft_stage1_profile("):
        assert fn in src


def _jax_product(eq, a, w, dtype):
    """The JAX package's product `jnp.einsum(eq, ...,
    preferred_element_type=f32).astype(dtype)` on the CPU: operands
    widened to f32 (exact for bf16), summed at Precision.HIGHEST.
    -> (the product in `dtype`, its f32 value) as torch tensors."""
    p32 = jnp.einsum(eq, jnp.asarray(a.float().numpy()),
                     jnp.asarray(w.float().numpy()),
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = np.array(p32.astype(jdt).astype(jnp.float32))
    return torch.from_numpy(out).to(dtype), torch.from_numpy(np.array(p32))


def _assert_within_roundings(got, want, scale, dtype):
    """f32: within 2^-18 of `scale` (an f32 sum's rounding, summed in
    another order).  bf16: each element within one bf16 ulp (2^-7
    relative) of `scale` (the magnitudes rounded on the way) plus one of
    the result, and fewer than 1% of the elements differ at all."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= 2.0 ** -18 * float(scale.max())
        return
    tol = (scale + torch.maximum(g.abs(), w.abs())) * 2.0 ** -7
    assert bool((d <= tol).all())
    assert float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage2_equals_the_jax_einsum(dtype):
    """`stage2_carrier_major` computes the JAX package's second stage
    (`fft_carrier_major_planar`'s "fskm,ml->lksf" products, each stored
    in the planes' dtype, then combined in it)."""
    n = 8192
    rng = np.random.default_rng(12)
    br, bi = (torch.from_numpy(rng.normal(size=(2, 3, 128, 64)).astype(
        np.float32)).to(dtype) for _ in range(2))
    _, w2, _ = jfft._tables(n)
    w2r, w2i = (torch.from_numpy(np.ascontiguousarray(p)).to(dtype)
                for p in (w2.real, w2.imag))
    got_r, got_i = mxu_fft.stage2_carrier_major(br, bi, n)
    assert got_r.dtype == dtype and got_r.is_contiguous()
    assert got_r.shape == got_i.shape == (n, 3, 2)
    for got, (b1, w1), (b2, w2_), sign in (
            (got_r, (br, w2r), (bi, w2i), -1),
            (got_i, (br, w2i), (bi, w2r), 1)):
        p1, s1 = _jax_product("fskm,ml->lksf", b1, w1, dtype)
        p2, s2 = _jax_product("fskm,ml->lksf", b2, w2_, dtype)
        want = (p1 - p2) if sign < 0 else (p1 + p2)
        scale = (s1.abs() + s2.abs()).reshape(n, 3, 2)
        _assert_within_roundings(got, want.reshape(n, 3, 2), scale, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage1_product_equals_the_jax_einsum(dtype):
    """The first stage's product of `fft_carrier_major_planar` is the JAX
    package's "fsnm,nk->fskm" einsum (accumulated in f32, stored in the
    dtype), and comes out contiguous."""
    rng = np.random.default_rng(13)
    y = torch.from_numpy(rng.normal(size=(2, 3, 128, 64)).astype(
        np.float32)).to(dtype)
    w1, _, _ = jfft._tables(8192)
    w = torch.from_numpy(np.ascontiguousarray(w1.real)).to(dtype)
    want, s32 = _jax_product("fsnm,nk->fskm", y, w, dtype)
    got = mxu_fft._stage1(y, w, dtype)
    assert got.dtype == dtype and got.is_contiguous()
    _assert_within_roundings(got, want, s32.abs(), dtype)


@pytest.mark.cuda
def test_k6_kernel_within_tolerance_of_plain_on_card():
    """Every n of `_FACTORS`, and symbol counts that leave the persistent
    grid's last round ragged or fill less than one round
    (`tools/fft_microbench.check_factors`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    records = fft_microbench.check_factors(log=lambda _: None)
    assert {r["n"] for r in records} == set(mxu_fft._FACTORS)
    assert any(r["symbols"] % r["ctas"] for r in records)
    assert all(r["ok"] for r in records)
