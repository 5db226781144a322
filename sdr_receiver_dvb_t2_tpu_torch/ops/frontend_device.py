"""Device-resident sample-domain front end: raw impaired device-rate IQ ->
corrected elementary-rate samples.  Port of
`sdr_receiver_dvb_t2_tpu/ops/frontend_device.py`: `make_frontend_symbols`
(the superstep's entry: GI-stripped OFDM symbols), `make_frontend` (whole
frame bodies), the streaming `DeviceFrontendChain` with
`make_rational_resampler`, and the impairment model (`make_resampler`,
`make_impairer`) that builds test and smoke input.

Stages (dvbt2_demodulator.cpp:182-221 in the reference receiver): per-frame
DC and 1-bit IQ-imbalance estimation and correction, NCO derotation with a
compensated per-frame phase, and a 17-tap generalized-Farrow resampler that
reads at the post-P1, post-guard sample grid.

The TPU version scans over OFDM symbols or output chunks; here every
(frame, symbol or chunk, sample) position is computed in one batched pass.  Scalar arguments
(cfo_hz, ratio, pos0, phase0) are taken as f32, as the TPU version's traced
scalars are, and every float operation runs in the same order: no
multiply-add is contracted, which `_mod2pi_prod` needs.  The small terms
(the estimates, the NCO's cos and sin, the window grid) run eagerly; the
slice corrector over the windows (`SliceCorrector`) is on the card one
launch of the hand-written kernel K8 (`csrc/frontend_correct.cu`), bit-equal
to its eager plain version, which CPU tensors take.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from .._device import DeviceConst
from ..utils.metrics import count


# --------------------------------------------------------------------------
# Generalized-Farrow tap bank (port's copy: the JAX module imports jax)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def farrow_bank(half: int = 8, deg: int = 7, m_max: float = 2.0,
                beta: float = 1.0):
    """Windowed-sinc interpolation taps fitted by per-tap polynomials in mu.

    Interpolating x at position (k + m), m in [0, m_max), uses taps
    j in [-half+1 .. half+1] with weight f(j - m), f(d) = sinc(d) *
    cos^2(pi d / (2 (half+1))); each weight is least-squares fitted over m
    by a degree-`deg` polynomial on Chebyshev nodes.

    Returns (coeffs (n_taps, deg+1) float64, highest degree first for
    Horner; j_offsets (n_taps,); max_fit_err)."""
    j = np.arange(-half + 1, half + 2)
    support = half + 1
    nn = 64
    t = np.cos((2 * np.arange(nn) + 1) * np.pi / (2 * nn))
    m = (t + 1.0) * 0.5 * m_max
    d = j[None, :] - m[:, None]
    w = np.sinc(d) * np.cos(np.pi * d / (2.0 * support)) ** (2.0 * beta)
    w[np.abs(d) >= support] = 0.0
    v = np.vander(m, deg + 1)
    coeffs, *_ = np.linalg.lstsq(v, w, rcond=None)
    err = float(np.abs(v @ coeffs - w).max())
    return coeffs, j, err


# the front end's bank: degree-7 fits, exact to 2e-4 (the JAX default)
DEG = 7
# default resampler output chunk: the stencil start is fixed per chunk, so
# chunk * |ratio - 1| must stay under ~0.9 (0.36 at 22 ppm)
CHUNK = 16384


def _bank(half: int):
    coeffs, j_off, fit_err = farrow_bank(half=half, deg=DEG)
    if fit_err >= 2e-4:
        raise ValueError(f"farrow fit error {fit_err}")
    return [[float(c) for c in coeffs[:, t]] for t in range(len(j_off))]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _horner(cf_t: list, mu: torch.Tensor) -> torch.Tensor:
    wt = torch.full_like(mu, cf_t[0])
    for c in cf_t[1:]:
        wt = wt * mu + c
    return wt


def _window_starts(s: torch.Tensor, n: int, length: int) -> torch.Tensor:
    """The starts (M,) that windows of `length` at s (M,) read from an axis
    of n, with the semantics of `jax.lax.dynamic_slice_in_dim`: a negative
    start counts from the end of the axis, then the start clamps into
    [0, n - length]."""
    return torch.where(s < 0, s + n, s).clamp(0, n - length)


def _slices(x: torch.Tensor, s: torch.Tensor, length: int) -> torch.Tensor:
    """x (F, n, ...) and starts s (M,) -> (F, M, length, ...) windows
    x[:, s_m : s_m + length], the starts taken as `_window_starts` does."""
    idx = (_window_starts(s, x.shape[1], length)[:, None]
           + torch.arange(length, device=x.device))
    return x[:, idx]


# --------------------------------------------------------------------------
# Correction front end (the product path)
# --------------------------------------------------------------------------

def _estimate_dciq(raw_r, raw_i):
    """Per-frame DC mean + 1-bit IQ-imbalance statistics
    (dvbt2_demodulator.cpp:187-192, 256-265).
    -> ((dc_i, dc_q, g, c, rs) each (F, 1), dc (F, 2), giq (F, 2))."""
    dc_i = raw_r.mean(1, keepdim=True)
    dc_q = raw_i.mean(1, keepdim=True)
    i0, q0 = raw_r - dc_i, raw_i - dc_q
    ei = i0.abs().mean(1, keepdim=True)
    eq = q0.abs().mean(1, keepdim=True)
    g = ei / eq.clamp(min=1e-12)
    c = (torch.sign(i0) * q0).mean(1, keepdim=True) / ei.clamp(min=1e-12)
    rs = 1.0 / torch.sqrt((1.0 - c * c).clamp(min=1e-6))
    return ((dc_i, dc_q, g, c, rs), torch.cat([dc_i, dc_q], 1),
            torch.cat([g, c], 1))


def _mod2pi_prod(w: torch.Tensor, n: int) -> torch.Tensor:
    """(w * n) mod 2pi to ~1e-6 rad for a static int n < 2^24 and f32 w:
    a Dekker two-product recovers the product's rounding error and a
    3-constant Cody-Waite reduction subtracts k*2pi without cancellation.
    Exact only if no operation is contracted into a multiply-add."""
    two_pi = 2.0 * np.pi
    c1 = float(np.float32(6.28125))
    c2 = float(np.float32(two_pi - 6.28125))
    c3 = float(np.float32(two_pi - 6.28125 - float(np.float32(two_pi
                                                               - 6.28125))))
    t = w * 4097.0
    w_hi = t - (t - w)
    w_lo = w - w_hi
    n_hi = float(n & ~0xFFF)
    n_lo = float(n & 0xFFF)
    p = w * float(n)
    err = ((w_hi * n_hi - p) + w_hi * n_lo + w_lo * n_hi) + w_lo * n_lo
    k = torch.round(p / two_pi)
    return ((p - k * c1) + err) - k * c2 - k * c3


def _nco_terms(cfo_hz, ratio, phase0, fs, slice_len, f, n_in):
    """NCO constants: rad/sample w, the fixed in-slice ramp cos/sin
    (1, slice_len) and the per-frame phase offsets (F,)."""
    w = 2.0 * math.pi * cfo_hz / (fs * ratio)
    mloc = torch.arange(slice_len, dtype=torch.float32, device=w.device)
    cr = torch.cos(w * mloc)[None, :]
    sr = torch.sin(w * mloc)[None, :]
    theta = _mod2pi_prod(w, int(n_in))
    foff = torch.arange(f, dtype=torch.float32, device=w.device) * theta
    return (w, cr, sr, foff, phase0)


def _window_phase(nco, s: torch.Tensor):
    """cos and sin (F, M) of the NCO phase at the window starts s (M,) of
    each frame: phase0 + fi*theta + w*s; the start s < 2^24 is exact in
    f32 (unclamped, as the TPU version's phase uses it)."""
    w, _, _, foff, phase0 = nco
    base = (phase0 + foff)[:, None] + w * s.float()[None, :]
    return torch.cos(base), torch.sin(base)


class SliceCorrector:
    """DC/IQ apply + NCO + Farrow Horner over windows of the raw planes.

    corrector(raw_r, raw_i (F, n_in) f32, pad, s (M,) int64, mu (M,
    out_len), est, nco, out_dtype=None) -> (out_r, out_i) of (F, M,
    out_len), f32 or `out_dtype`: the raw planes are read as if zero-padded
    by `pad` samples; window m starts at raw index s[m] (taken as
    `_window_starts` does) and output sample l of it interpolates at
    s[m] + l + mu[m, l] (+ the stencil offset).  A CPU tensor takes
    `plain`, a CUDA tensor `kernel` (K8, `csrc/frontend_correct.cu`); the
    two are bit-equal.  The tracer's counter "frontend.kernel_frames" adds
    the frames K8 corrected (0 on the CPU)."""

    def __init__(self, out_len: int, slice_len: int, cf):
        self.out_len, self.slice_len, self.cf = out_len, slice_len, cf
        flat = [c for cf_t in cf for c in cf_t]
        self._coef = (ctypes.c_float * len(flat))(*flat)

    def __call__(self, raw_r, raw_i, pad, s, mu, est, nco, out_dtype=None):
        if raw_r.device.type == "cpu":
            out = self.plain(raw_r, raw_i, pad, s, mu, est, nco, out_dtype)
        else:
            out = self.kernel(raw_r, raw_i, pad, s, mu, est, nco, out_dtype)
        count("frontend.kernel_frames", raw_r.shape[0] if raw_r.is_cuda
              else 0)
        return out

    def plain(self, raw_r, raw_i, pad, s, mu, est, nco, out_dtype=None):
        """The plain PyTorch version on any device: the raw planes padded
        with `pad` zeros, then every operation one eager pass over (F, M,
        slice_len), then the cast to `out_dtype`."""
        out_len, slice_len = self.out_len, self.slice_len
        dc_i, dc_q, g, c, rs = est
        _, cr, sr, _, _ = nco
        xr = torch.nn.functional.pad(raw_r, (0, pad))
        xi = torch.nn.functional.pad(raw_i, (0, pad))
        sli = _slices(xr, s, slice_len)               # (F, M, slice_len)
        slq = _slices(xi, s, slice_len)
        i = sli - dc_i[:, :, None]
        q = ((slq - dc_q[:, :, None]) * g[:, :, None]
             - c[:, :, None] * i) * rs[:, :, None]
        cb, sb = (v[..., None] for v in _window_phase(nco, s))
        cm = cb * cr - sb * sr
        sm = sb * cr + cb * sr
        ir = i * cm + q * sm
        qr = q * cm - i * sm
        accr = acci = None
        for t, cf_t in enumerate(self.cf):
            wt = _horner(cf_t, mu)
            tr = ir[..., t:t + out_len] * wt
            tq = qr[..., t:t + out_len] * wt
            accr = tr if accr is None else accr + tr
            acci = tq if acci is None else acci + tq
        if out_dtype is not None:
            accr, acci = accr.to(out_dtype), acci.to(out_dtype)
        return accr, acci

    def kernel(self, raw_r, raw_i, pad, s, mu, est, nco, out_dtype=None):
        """K8 (CUDA tensors only): the raw planes read in place, each
        window position once per frame, the outputs written once."""
        f, n_in = raw_r.shape
        dev = raw_r.device
        if not raw_r.is_cuda or raw_r.dtype != torch.float32 \
                or raw_i.shape != raw_r.shape or raw_i.dtype != raw_r.dtype \
                or raw_i.device != dev or raw_i.stride() != raw_r.stride():
            raise ValueError(
                "frontend_correct_cuda: expected two CUDA f32 (F, n_in) "
                f"planes of one shape and strides, got {tuple(raw_r.shape)} "
                f"{raw_r.dtype} on {dev} and {tuple(raw_i.shape)} "
                f"{raw_i.dtype} on {raw_i.device}")
        dtype = torch.float32 if out_dtype is None else out_dtype
        starts = _window_starts(s, n_in + pad, self.slice_len)
        cb, sb = _window_phase(nco, s)
        shape = (f, s.shape[0], self.out_len)
        out_r = torch.empty(shape, dtype=dtype, device=dev)
        out_i = torch.empty(shape, dtype=dtype, device=dev)
        frontend_correct_cuda(self, raw_r, raw_i, starts, mu, est, cb, sb,
                              nco, out_r, out_i)
        return out_r, out_i


def _lib() -> ctypes.CDLL:
    lib = _build.load("frontend_correct")
    if lib.frontend_correct.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.frontend_correct.argtypes = ([p] * 2 + [ll] * 3 + [p] * 13
                                         + [i] * 4 + [p] + [i] * 3 + [p])
        lib.frontend_correct.restype = i
        lib.frontend_correct_error_string.argtypes = [i]
        lib.frontend_correct_error_string.restype = ctypes.c_char_p
    return lib


_OUT_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def frontend_correct_cuda(corrector: SliceCorrector, raw_r, raw_i, starts,
                          mu, est, cb, sb, nco, out_r, out_i):
    """K8 on the card: `corrector`'s tap bank, the raw f32 planes (F, n_in)
    (any strides, the same for both), the clamped window starts (M,), mu
    (M, out_len), est's five (F, 1) terms, cb and sb (F, M), nco's cr and
    sr (1, slice_len), all CUDA tensors of one device; writes out_r and
    out_i, contiguous (F, M, out_len) of f32 or bf16."""
    dev = raw_r.device
    f, n_in = raw_r.shape
    m = starts.shape[0]
    _, cr, sr, _, _ = nco
    flat = [v.contiguous() for v in
            (mu, *est, cb, sb, cr, sr)]
    starts = starts.to(torch.int64).contiguous()
    for t in flat + [starts, out_r, out_i]:
        if not t.is_cuda or t.device != dev:
            raise ValueError("frontend_correct_cuda needs CUDA tensors on "
                             "one device")
    if any(t.dtype != torch.float32 for t in flat):
        raise ValueError("frontend_correct_cuda: mu, the estimates and the "
                         "NCO terms must be f32")
    shape = (f, m, corrector.out_len)
    if out_r.dtype not in _OUT_BYTES or out_i.dtype != out_r.dtype \
            or tuple(out_r.shape) != shape or tuple(out_i.shape) != shape \
            or not out_r.is_contiguous() or not out_i.is_contiguous():
        raise ValueError("frontend_correct_cuda: out_r and out_i must be "
                         f"contiguous f32 or bf16 {shape} tensors")
    mu, dc_i, dc_q, g, c, rs, cb, sb, cr, sr = flat
    if tuple(mu.shape) != (m, corrector.out_len) \
            or any(v.numel() != f for v in (dc_i, dc_q, g, c, rs)) \
            or any(tuple(v.shape) != (f, m) for v in (cb, sb)) \
            or any(v.numel() != corrector.slice_len for v in (cr, sr)):
        raise ValueError("frontend_correct_cuda: mu, the estimates or the "
                         "NCO terms do not match the planes and windows")
    n_taps = len(corrector.cf)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.frontend_correct(
            raw_r.data_ptr(), raw_i.data_ptr(), *raw_r.stride(), n_in,
            starts.data_ptr(), *(t.data_ptr() for t in flat),
            out_r.data_ptr(), out_i.data_ptr(), f, m, corrector.out_len,
            corrector.slice_len, ctypes.addressof(corrector._coef), n_taps,
            len(corrector.cf[0]) - 1, _OUT_BYTES[out_r.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("frontend_correct_cuda: "
                           + lib.frontend_correct_error_string(err).decode())
    frontend_correct_cuda.launches += 1
    return out_r, out_i


frontend_correct_cuda.launches = 0


def _chunk_grid(n_chunks: int, chunk: int, pos0, delta, half: int, dev):
    """Stencil starts s (n_chunks,) int64 and fractional positions mu
    (n_chunks, chunk) of a chunked drift resampler: output k reads at
    pos0 + k*(1 + delta); within a chunk the start is fixed and the drift
    folds into mu in [0, ~2).  The f32 operations and their order are the
    TPU version's (the stencil start is taken per chunk, so the chunk size
    shows in the output's last bits)."""
    k_local = torch.arange(chunk, dtype=torch.float32, device=dev)
    c = torch.arange(n_chunks, dtype=torch.float32, device=dev)
    r0 = pos0 + c * chunk * delta
    r = r0[:, None] + k_local * delta
    b = torch.floor(torch.minimum(r0, r0 + (chunk - 1) * delta))
    mu = r - b[:, None]
    s = (c * chunk + b).to(torch.int64) - (half - 1)
    return s, mu


def make_frontend(n_out: int, fs: float, half: int = 8, chunk: int = CHUNK,
                  planar: bool = False):
    """Full steady-state correction chain, batched over frames.

    fn(raw (F, n_in, 2), cfo_hz, ratio, pos0, phase0)
      -> (out (F, n_out, 2), dc (F, 2), giq (F, 2))

    Stages in the reference receiver's order
    (dvbt2_demodulator.cpp:182-221): DC removal (per-frame mean), IQ
    imbalance (1-bit statistic), NCO derotation at the DEVICE rate fs*ratio
    (applied to the raw samples, phase continuous across the frame axis),
    and generalized-Farrow resampling back to the elementary rate in
    chunks of `chunk` outputs (ratio = device rate / fs).

    With planar=True the signature is fn(raw_r (F, n_in), raw_i (F, n_in),
    ...) -> ((out_r, out_i), dc, giq)."""
    cf = _bank(half)
    n_chunks = -(-n_out // chunk)
    slice_len = chunk + 2 * half + 2
    correct = SliceCorrector(chunk, slice_len, cf)

    def frontend_planar(raw_r, raw_i, cfo_hz, ratio, pos0, phase0):
        f, n_in = raw_r.shape
        dev = raw_r.device
        cfo_hz, ratio, pos0, phase0 = (_f32(v, dev) for v in
                                       (cfo_hz, ratio, pos0, phase0))
        est, dc_out, giq = _estimate_dciq(raw_r, raw_i)
        nco = _nco_terms(cfo_hz, ratio, phase0, fs, slice_len, f, n_in)
        pad = max(n_chunks * chunk + slice_len - n_in + half, 0)
        s, mu = _chunk_grid(n_chunks, chunk, pos0, ratio - 1.0, half, dev)
        out_r, out_i = correct(raw_r, raw_i, pad, s, mu, est, nco)
        return ((out_r.reshape(f, n_chunks * chunk)[:, :n_out],
                 out_i.reshape(f, n_chunks * chunk)[:, :n_out]),
                dc_out, giq)

    frontend_planar.correct = correct
    if planar:
        return frontend_planar

    def frontend(raw, cfo_hz, ratio, pos0, phase0):
        (out_r, out_i), dc_out, giq = frontend_planar(
            raw[..., 0], raw[..., 1], cfo_hz, ratio, pos0, phase0)
        return torch.stack([out_r, out_i], -1), dc_out, giq

    frontend.correct = correct
    return frontend


def make_frontend_symbols(n_sym: int, sym_size: int, guard: int, fs: float,
                          p1_len: int = 2048, half: int = 8, sym_order=None,
                          out_dtype=None):
    """Correction front end emitting GI-stripped OFDM symbols directly.

    fn(raw_r (F, n_in), raw_i (F, n_in), cfo_hz, ratio, pos0, phase0)
      -> ((sym_r, sym_i) each (F, n_sym, fft), dc (F, 2), giq (F, 2))

    Output (l, j) interpolates the raw at (p1_len + l*sym_size + guard + j)
    * ratio + pos0; symbols are emitted in `sym_order` (a permutation of
    range(n_sym)) and cast to `out_dtype` when given.  The in-symbol drift
    fft*|ratio-1| must stay under ~0.9."""
    fft = sym_size - guard
    order = (np.arange(n_sym) if sym_order is None
             else np.asarray(sym_order, np.int64))
    if sorted(order.tolist()) != list(range(n_sym)):
        raise ValueError("sym_order is not a permutation of the symbols")
    cf = _bank(half)
    slice_len = fft + 2 * half + 2
    correct = SliceCorrector(fft, slice_len, cf)
    # first post-guard sample of each emitted symbol, clean coordinates
    # (copied to a device once: a copy from host memory per call would
    # wait for the device)
    k0_const = DeviceConst(p1_len + order * sym_size + guard)

    def frontend(raw_r, raw_i, cfo_hz, ratio, pos0, phase0):
        f, n_in = raw_r.shape
        dev = raw_r.device
        cfo_hz, ratio, pos0, phase0 = (_f32(v, dev) for v in
                                       (cfo_hz, ratio, pos0, phase0))
        est, dc_out, giq = _estimate_dciq(raw_r, raw_i)
        nco = _nco_terms(cfo_hz, ratio, phase0, fs, slice_len, f, n_in)
        pad = max(int(np.ceil((p1_len + n_sym * sym_size + 2) * 1.001))
                  + slice_len - n_in + half, 0)
        k_local = torch.arange(fft, dtype=torch.float32, device=dev)
        delta = ratio - 1.0
        k0 = k0_const.on(dev)
        r0 = pos0 + k0.float() * delta                   # (n_sym,)
        r = r0[:, None] + k_local * delta
        b = torch.floor(torch.minimum(r0, r0 + (fft - 1) * delta))
        mu = r - b[:, None]
        s = (k0 + b.to(torch.int64)) - (half - 1)
        sym_r, sym_i = correct(raw_r, raw_i, pad, s, mu, est, nco,
                               out_dtype)
        return (sym_r, sym_i), dc_out, giq

    frontend.correct = correct
    return frontend


# --------------------------------------------------------------------------
# Impairment model (test and smoke input synthesis: the inverse chain)
# --------------------------------------------------------------------------

def make_resampler(n_out: int, half: int = 8, chunk: int = CHUNK):
    """Batched arbitrary resampler: (F, n_in, 2) -> (F, n_out, 2).

    Output sample k of every frame interpolates its frame's input at
    pos0 + k*ratio, in chunks of `chunk` outputs whose stencil start is
    fixed (the in-chunk drift folds into mu in [0, ~2)), exactly as the TPU
    version chunks it; chunk * |ratio - 1| must stay under ~0.9 and pos0
    must leave `half` samples of left context.

    Returns fn(x (F, n_in, 2), ratio, pos0) -> (F, n_out, 2)."""
    cf = _bank(half)
    n_chunks = -(-n_out // chunk)
    slice_len = chunk + 2 * half + 2

    def resample(x, ratio, pos0):
        f, n_in = x.shape[0], x.shape[1]
        dev = x.device
        pad = n_chunks * chunk + slice_len - n_in + half
        x = torch.nn.functional.pad(x, (0, 0, 0, max(pad, 0)))
        s, mu = _chunk_grid(n_chunks, chunk, _f32(pos0, dev),
                            _f32(ratio, dev) - 1.0, half, dev)
        sl = _slices(x, s, slice_len)              # (F, n_chunks, len, 2)
        acc = None
        for t, cf_t in enumerate(cf):
            term = sl[:, :, t:t + chunk] * _horner(cf_t, mu)[..., None]
            acc = term if acc is None else acc + term
        return acc.reshape(f, n_chunks * chunk, 2)[:, :n_out]

    return resample


def frontend_raw_len(n_samp: int, sco: float, half: int = 8) -> int:
    """Raw device-rate samples a frame of n_samp corrected samples needs
    (the impairer/corrector position-calibration convention: 2*half clean
    pre-pad eaten as left context, plus interpolation slack)."""
    return int(np.ceil((n_samp + 2 * half) * (1.0 + sco))) + 4 * half


def make_impairer(n_raw: int, fs: float, half: int = 8):
    """Synthesize raw device-rate captures from clean elementary-rate
    frames: the inverse order of the front end plus int16 quantization.

    fn(clean (F, n, 2), cfo_hz, ratio, phase0, dc (2,), giq (2,),
       generator, nvar) -> (F, n_raw, 2); ratio = device rate / elementary
    rate; AWGN of variance nvar/2 per plane, drawn from the torch.Generator
    `generator` on the data's device, is added before quantization when
    nvar > 0.  The int16 grid puts the clean frames' peak |plane| at
    32000."""
    resample = make_resampler(n_raw, half=half)

    def impair(clean, cfo_hz, ratio, phase0, dc, giq, generator, nvar):
        f = clean.shape[0]
        dev = clean.device
        cfo_hz, ratio, phase0 = (_f32(v, dev) for v in
                                 (cfo_hz, ratio, phase0))
        x = resample(clean, 1.0 / ratio, float(half))
        w = 2.0 * math.pi * cfo_hz / (fs * ratio)
        m = torch.arange(n_raw, dtype=torch.float32, device=dev)
        # per-frame advance reduced mod 2pi with the same compensated
        # arithmetic the correction front end uses
        base = phase0 + _mod2pi_prod(w, n_raw) \
            * torch.arange(f, dtype=torch.float32, device=dev)
        ph = torch.remainder(base[:, None] + w * m[None, :], 2.0 * math.pi)
        cs, sn = torch.cos(ph), torch.sin(ph)
        i, q = x[..., 0], x[..., 1]
        i, q = i * cs - q * sn, q * cs + i * sn
        g, c = giq[0], giq[1]
        q = (q * torch.sqrt(1.0 - c * c) + c * i) / g
        x = torch.stack([i, q], -1) + dc
        if float(nvar) > 0:
            noise = torch.randn(x.shape, generator=generator, device=dev)
            x = x + noise * math.sqrt(float(nvar) / 2.0)
        peak = clean.abs().max()
        s = 32000.0 / peak
        return torch.round(torch.clamp(x * s, -32767.0, 32767.0)) / s

    return impair


# --------------------------------------------------------------------------
# Rational polyphase resampler (wide fixed ratios: vendor rate conversion)
# --------------------------------------------------------------------------

def make_rational_resampler(num: int, den: int, half: int = 8):
    """Polyphase resampler for an exact rational ratio num/den (input
    samples per output sample), for the vendor-rate conversions the chunked
    drift resampler cannot reach (its chunk length bounds |ratio-1|):
    AirSpy 10 Msps -> 9.142857 is 35/32.

    Output k = a*den + r reads input positions a*num + floor(r*num/den) + j
    with a fixed fractional phase per r, so each of the den phases is
    2*half+1 static column slices of a window of `spill` input samples
    starting at a*num (windows overlap where spill > num), weighted by
    scalars evaluated from the fitted Farrow bank at build time.  The
    window holds the whole stencil at every ratio: at 5/4 and 7/4 (the
    10 Msps AirSpy on 7 and 5 MHz channels) it spans more than two rows,
    where the TPU version, which extends a row by the next row only,
    clamps the columns beyond and its output differs from this one.

    Returns (resample, spill): resample(x (F, n_in)) -> ((F, A*den), A)
    with A = (n_in - spill - num) // num whole input rows consumed; the
    caller carries the remainder as a halo (integer-exact streaming)."""
    cf = _bank(half)
    n_taps = len(cf)
    offs = [int((r * num) // den) for r in range(den)]
    mus = [float((r * num) / den - (r * num) // den) for r in range(den)]
    wtab = []
    for mu in mus:
        row = []
        for cf_t in cf:
            w = 0.0
            for c in cf_t:
                w = w * mu + c
            row.append(w)
        wtab.append(row)
    spill = max(offs) + n_taps + 2

    def resample(x):
        f, n_in = x.shape
        a_blocks = (n_in - spill - num) // num
        if a_blocks <= 0:
            return x.new_zeros((f, 0)), 0
        # (F, A, spill): window a is x[a*num : a*num + spill]
        xe = x[:, :(a_blocks - 1) * num + spill].unfold(1, spill, num)
        # all den phases at once, tap by tap in the TPU version's order:
        # phase r reads columns offs[r] + t of its row
        cols = torch.as_tensor(offs, device=x.device)
        w = torch.as_tensor(wtab, dtype=x.dtype, device=x.device)
        acc = None
        for t in range(n_taps):
            term = xe[:, :, cols + t] * w[:, t]        # (F, A, den)
            acc = term if acc is None else acc + term
        return acc.reshape(f, a_blocks * den), a_blocks

    return resample, spill


# --------------------------------------------------------------------------
# Streaming front-end chain (the CorrectorChain interface, on the device)
# --------------------------------------------------------------------------

def _to_pairs(x: np.ndarray, device) -> torch.Tensor:
    """Contiguous complex64 (n,) on the host -> f32 (n, 2) re/im pairs on
    `device`: complex64 IS interleaved f32 pairs, so nothing is repacked."""
    return torch.from_numpy(x.view(np.float32).reshape(-1, 2)).to(device)


def _from_pairs(t: torch.Tensor) -> np.ndarray:
    """f32 (n, 2) re/im pairs on any device -> complex64 (n,) on the
    host."""
    return t.contiguous().cpu().numpy().view(np.complex64).reshape(-1)


class UnsupportedRatio(ValueError):
    """The device chain refuses this in/out rate ratio; the caller keeps
    the host chain."""


class _DCIQView:
    """chain.dciq duck type (io/devices.py stats surface)."""

    def __init__(self):
        self.dc = 0.0 + 0.0j
        self.g = 1.0
        self.c = 0.0


class DeviceFrontendChain:
    """Streaming sample-domain front end on a torch device: the
    rx/frontend.CorrectorChain interface (process / add_frequency /
    rebase_ratio / freq_hz / ratio / dciq) with the correction stages of
    this module: DC/IQ estimate and apply, generalized-Farrow resampling,
    NCO derotation on the OUTPUT samples (StreamCorrector's order; note
    `make_frontend` derotates the raw input instead).

    The host tracks the exact float read position and output count (the
    bookkeeping of rx/frontend.StreamCorrector): each call hands the
    device the halo plus the new block and keeps the outputs those samples
    determine.  The DC/IQ estimates blend across blocks with an EMA
    carried as a device tensor (the first block enters with weight 1).
    The TPU version pads every call to static input and output buckets so
    that it compiles once; eager PyTorch runs each call at its own length,
    and the bucket sizes survive only as the limits above which a call is
    split.

    Supported ratios: the chunked drift resampler covers |ratio-1| <=
    ~0.012 (the 9.2 Msps SdrPlay/Pluto rates, +0.625%, and elementary-rate
    captures with clock error); wider exact small rationals of the
    elementary rate (the 10 Msps AirSpy's 35/32) get a polyphase stage
    (`make_rational_resampler`, whose window holds the stencil at any
    ratio: also 5/4 and 7/4, 10 Msps on 7 and 5 MHz channels) ahead of
    the drift stage.  Anything else
    raises UnsupportedRatio (a ValueError) and keeps the host chain
    (StreamingReceiver catches that one error, logs it and falls back)."""

    MAX_RATIO_DEV = 0.012

    def __init__(self, in_rate: float, out_rate: float, block_len: int,
                 taps_half: int = 8, alpha: float = 0.25, *, device):
        self.device = torch.device(device)
        self.fs = out_rate
        self.in_rate = in_rate
        self._base_ratio = in_rate / out_rate
        self._rat = None
        if abs(self._base_ratio - 1.0) > self.MAX_RATIO_DEV:
            # wide fixed ratio: the DVB-T2 device rates are exact small
            # rationals of the elementary rate (AirSpy 10 Msps = 35/32,
            # SdrPlay/Pluto 9.2 Msps = 161/160, handled by the chunked
            # stage alone); insert the polyphase stage and leave only
            # the ppm-scale residual to the drift resampler
            from fractions import Fraction
            fr = Fraction(self._base_ratio).limit_denominator(64)
            if (fr.denominator > 64 or fr.numerator <= fr.denominator
                    or abs(float(fr) - self._base_ratio) > 1e-9):
                raise UnsupportedRatio(
                    f"device chain supports |ratio-1| <= "
                    f"{self.MAX_RATIO_DEV} or exact small rationals; "
                    f"{in_rate}/{out_rate} needs the host chain")
            self._rat_fn, self._rat_spill = make_rational_resampler(
                fr.numerator, fr.denominator, half=taps_half)
            # largest input of one polyphase call; longer ones are split
            self._rat_L = block_len + self._rat_spill + 2 * fr.numerator
            self._rat = (fr.numerator, fr.denominator)
            self._rat_halo = np.zeros(0, np.complex64)
        self.freq_hz = 0.0
        self.ratio = self._base_ratio
        self._post = []              # host re-lock splice stages
        self.dciq = _DCIQView()
        self.alpha = alpha
        self.half = taps_half
        self._phase = 0.0           # NCO phase of the next OUTPUT sample
        self._dphi = 0.0
        self._halo = np.zeros(0, np.complex64)
        # start the read position `half` samples in, so the first chunk's
        # stencil never needs left context the stream doesn't have (a
        # negative slice start would skew the first few outputs)
        self._pos = float(taps_half)
        self._blocks = 0
        self._dciq_state = torch.tensor([0.0, 0.0, 1.0, 0.0],
                                        dtype=torch.float32,
                                        device=self.device)
        # largest input and output of one call: halo stays < taps + ratio
        # slack + chunk drift
        self._H = 4 * taps_half + 64
        self._L = block_len + self._H
        chunk = 64
        while chunk * 2 * (self.MAX_RATIO_DEV + 1e-4) <= 0.9 \
                and chunk < 16384:
            chunk *= 2
        self._chunk = chunk
        self._n_max = int(self._L / (1.0 - self.MAX_RATIO_DEV)) + 2

    def _correct(self, x2, state, ratio, pos0, phase0, dphi, first: bool,
                 n_out: int):
        """One block on the device: x2 (n_in, 2) f32 -> (out (n_out, 2),
        the new DC/IQ state (4,))."""
        dev = x2.device
        i, q = x2[:, 0], x2[:, 1]
        inv_n = 1.0 / torch.full((), float(max(x2.shape[0], 1)),
                                 dtype=torch.float32, device=dev)
        dc_i = i.sum() * inv_n
        dc_q = q.sum() * inv_n
        i = i - dc_i
        q = q - dc_q
        ei = i.abs().sum() * inv_n
        eq = q.abs().sum() * inv_n
        g_b = ei / eq.clamp(min=1e-12)
        c_b = (torch.sign(i) * q).sum() * inv_n / ei.clamp(min=1e-12)
        w = 1.0 if first else float(self.alpha)
        new_state = (1 - w) * state + w * torch.stack([dc_i, dc_q, g_b, c_b])
        g_s, c_s = new_state[2], new_state[3]
        q = (q * g_s - c_s * i) / torch.sqrt(
            (1.0 - c_s * c_s).clamp(min=1e-6))
        resample = make_resampler(n_out, half=self.half, chunk=self._chunk)
        y = resample(torch.stack([i, q], -1)[None], ratio, pos0)[0]
        # NCO on OUTPUT samples (StreamCorrector order/semantics)
        ph = _f32(phase0, dev) + _f32(dphi, dev) * torch.arange(
            n_out, dtype=torch.float32, device=dev)
        cs, sn = torch.cos(ph), torch.sin(ph)
        yi, yq = y[:, 0], y[:, 1]
        return torch.stack([yi * cs + yq * sn, yq * cs - yi * sn], -1), \
            new_state

    def _rational_process(self, block: np.ndarray) -> np.ndarray:
        """Stage 0: exact-rational vendor-rate conversion (polyphase,
        integer-exact halo bookkeeping on host)."""
        num, den = self._rat
        x = np.concatenate([self._rat_halo,
                            np.asarray(block, np.complex64)])
        n_true = len(x)
        if n_true > self._rat_L:
            # oversized call (re-fed buffer): feed bounded pieces through
            # this same path; the halo carries across pieces
            cut = self._rat_L - self._rat_spill - 2 * num
            self._rat_halo = np.zeros(0, np.complex64)
            return np.concatenate([self._rational_process(x[i:i + cut])
                                   for i in range(0, n_true, cut)])
        a_blocks = max(0, (n_true - self._rat_spill - num) // num)
        out2, _ = self._rat_fn(_to_pairs(x, self.device).t())
        self._rat_halo = x[a_blocks * num:]
        return _from_pairs(out2[:, :a_blocks * den].t())

    @property
    def _fine_ratio(self) -> float:
        """Ratio the drift stage runs at: the base ratio over the
        rational stage.  SCO re-lock factors live in host POST-stages
        and never widen this, so the Farrow mu-range bound holds for
        the life of the chain."""
        if self._rat is None:
            return self._base_ratio
        num, den = self._rat
        return self._base_ratio * den / num

    def process(self, block: np.ndarray) -> np.ndarray:
        if self._rat is not None:
            block = self._rational_process(block)
            if len(block) == 0 and len(self._halo) == 0:
                return np.zeros(0, np.complex64)
        y = self._process_fine(np.asarray(block, np.complex64))
        # SCO re-lock post-stages (host StreamCorrectors appended by
        # rebase_ratio) consume the device chain's OUTPUT
        for s in self._post:
            y = s.process(y)
        return y

    def _process_fine(self, block: np.ndarray) -> np.ndarray:
        """The device stage (DC/IQ + drift resampler + NCO); the rational
        vendor-rate stage has already run."""
        x = np.concatenate([self._halo, block])
        n_in = len(x)
        taps = 2 * self.half + 1
        n_out = int((n_in - taps - self._pos) / self._fine_ratio)
        if n_out <= 0:
            self._halo = x
            return np.zeros(0, np.complex64)
        if n_in > self._L or n_out > self._n_max:
            # oversized call (e.g. a re-fed acquisition buffer): split
            # into chain-sized pieces THROUGH THIS STAGE ONLY; re-entering
            # process() would run the rational stage a second time
            cut = (self._L - self._H) // 2
            self._halo = np.zeros(0, np.complex64)
            outs = [self._process_fine(x[i:i + cut])
                    for i in range(0, n_in, cut)]
            return np.concatenate([o for o in outs if len(o)]) \
                if outs else np.zeros(0, np.complex64)
        first = self._blocks == 0
        self._blocks += 1
        out, self._dciq_state = self._correct(
            _to_pairs(x, self.device), self._dciq_state,
            np.float32(self._fine_ratio), np.float32(self._pos),
            np.float32(self._phase), np.float32(self._dphi), first, n_out)
        st = self._dciq_state.cpu().numpy()
        self.dciq.dc = complex(st[0], st[1])
        self.dciq.g = float(st[2])
        self.dciq.c = float(st[3])
        # keep `half` samples of PERMANENT left context in the halo so the
        # read position never drops below the stencil's reach
        adv = self._pos + n_out * self._fine_ratio
        drop = max(0, int(np.floor(adv)) - self.half)
        self._halo = x[drop:]
        self._pos = adv - drop
        self._phase = float(np.mod(self._phase + self._dphi * n_out,
                                   2.0 * np.pi))
        return _from_pairs(out)

    def add_frequency(self, df_hz: float, applied_samples: int = 0) -> None:
        self.freq_hz += df_hz
        self._dphi = 2.0 * np.pi * self.freq_hz / self.fs
        self._phase = float(np.mod(
            self._phase + 2.0 * np.pi * df_hz / self.fs * applied_samples,
            2.0 * np.pi))

    def rebase_ratio(self, pending: np.ndarray, factor: float) -> np.ndarray:
        """SCO re-lock splice: append a host resampler POST-stage whose
        halo is seeded from the caller's pending (corrected OUTPUT)
        buffer, the CorrectorChain.rebase_ratio mechanism, so the splice
        stays sample-exact and nothing re-enters the input-side
        correction.  The device stage is untouched (its ratio stays inside
        the Farrow bank's fitted mu range no matter how many re-locks
        accumulate); only the rare re-lock event pays host-resampler
        cost."""
        from ..rx import frontend as hostfe
        tail = hostfe.StreamCorrector(fs=self.fs, taps=24)
        tail.ratio = factor
        tail._resampling = True
        self.ratio *= factor
        pending = np.asarray(pending, np.complex64)
        n_out = int((len(pending) - tail.taps) / factor)
        if n_out <= 0:
            tail._halo = pending
            self._post.append(tail)
            return np.zeros(0, np.complex64)
        out = hostfe._sinc_interp(pending, 0.0, factor, n_out, tail.taps)
        adv = n_out * factor
        drop = int(np.floor(adv))
        tail._halo = pending[drop:]
        tail._pos = adv - drop
        self._post.append(tail)
        return out
