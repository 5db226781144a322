"""The front end's slice corrector (sdr_receiver_dvb_t2_tpu_torch/ops/
frontend_device.py `SliceCorrector`): the plain version and the
hand-written kernel K8 (csrc/frontend_correct.cu).

On the CPU:
- the plain version gives the corrector's earlier output bit for bit
  (`_correct_before` below is that code as it was, on planes padded by the
  caller);
- an emulation of the kernel's tiling and indexing, written beside
  `csrc/frontend_correct.cu` (tiles of 1024 outputs, 4 a thread, the span's
  positions staged as tid + 256 r, reads past n_in as 0, the clamped
  starts, the 16-byte shared-memory chunks and the order in which they feed
  each output's taps), equals the plain version bit for bit at small
  shapes of both callers: symbol windows in a `sym_order`, chunked
  `make_frontend` on interleaved input with a ragged end, a negative start,
  and windows that read past the raw planes' end;
- CPU tensors take the plain version: no launch, 0 frames counted.
The `cuda`-marked tests hold K8 to the plain version on the card at the UK
HD step's shape (F=64, bf16 out) and at `make_frontend`'s f32 chunked
shape, and count one launch of 64 frames in one `Superstep` call.
"""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as fd
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
from sdr_receiver_dvb_t2_tpu_torch.utils.metrics import TRACER

torch.set_num_threads(1)

FS = 9.142857e6
HALF = 8
SCO = 2.2e-5
# K8's launch shape (csrc/frontend_correct.cu)
THREADS, PER, TAPS = 256, 4, 17
TL = THREADS * PER
SPAN = TL + TAPS - 1
R = -(-SPAN // THREADS)
CHUNKS = (PER + TAPS - 1) // 4


def _correct_before(out_len, slice_len, cf):
    """The slice corrector as `_make_slice_corrector` built it before the
    kernel came (its windows, its DC/IQ apply, its NCO and its taps)."""

    def slices(x, s, length):
        n = x.shape[1]
        s = torch.where(s < 0, s + n, s).clamp(0, n - length)
        idx = s[:, None] + torch.arange(length, device=x.device)
        return x[:, idx]

    def correct(xr, xi, s, mu, est, nco):
        dc_i, dc_q, g, c, rs = est
        w, cr, sr, foff, phase0 = nco
        sli = slices(xr, s, slice_len)
        slq = slices(xi, s, slice_len)
        i = sli - dc_i[:, :, None]
        q = ((slq - dc_q[:, :, None]) * g[:, :, None]
             - c[:, :, None] * i) * rs[:, :, None]
        base = (phase0 + foff)[:, None] + w * s.float()[None, :]
        cb, sb = torch.cos(base)[..., None], torch.sin(base)[..., None]
        cm = cb * cr - sb * sr
        sm = sb * cr + cb * sr
        ir = i * cm + q * sm
        qr = q * cm - i * sm
        accr = acci = None
        for t, cf_t in enumerate(cf):
            wt = fd._horner(cf_t, mu)
            tr = ir[..., t:t + out_len] * wt
            tq = qr[..., t:t + out_len] * wt
            accr = tr if accr is None else accr + tr
            acci = tq if acci is None else acci + tq
        return accr, acci

    return correct


def _emulate_k8(corr, raw_r, raw_i, pad, s, mu, est, nco, out_dtype=None):
    """K8's tiling and indexing in PyTorch on the CPU, every step one f32
    operation in the kernel's order; outputs it never writes stay NaN."""
    f, n_in = raw_r.shape
    n_win, out_len, slice_len = s.shape[0], corr.out_len, corr.slice_len
    starts = fd._window_starts(s, n_in + pad, slice_len)
    cb, sb = fd._window_phase(nco, s)
    cr, sr = (v.reshape(-1) for v in nco[1:3])
    dc_i, dc_q, g, c, rs = (v.reshape(f, 1) for v in est)
    coef = torch.tensor(np.float32(corr.cf))              # (TAPS, 8)
    tid = torch.arange(THREADS)
    j = (tid[None, :] + THREADS * torch.arange(R)[:, None]).reshape(-1)
    j = j[j < SPAN]                       # the span's staged positions
    out = torch.full((2, f, n_win, out_len), float("nan"))
    for m in range(n_win):
        for l0 in range(0, out_len, TL):
            e = starts[m] + l0 + j
            x = torch.where(e < n_in, raw_r[:, e.clamp(max=n_in - 1)], 0.0)
            y = torch.where(e < n_in, raw_i[:, e.clamp(max=n_in - 1)], 0.0)
            pos = (l0 + j).clamp(max=slice_len - 1)
            in_slice = l0 + j < slice_len
            crj = torch.where(in_slice, cr[pos], 0.0)
            srj = torch.where(in_slice, sr[pos], 0.0)
            i = x - dc_i
            q = ((y - dc_q) * g - c * i) * rs
            cbm, sbm = cb[:, m:m + 1], sb[:, m:m + 1]
            cm = cbm * crj - sbm * srj
            sm = sbm * crj + cbm * srj
            rot = torch.full((2, f, SPAN), float("nan"))
            rot[0][:, j] = i * cm + q * sm
            rot[1][:, j] = q * cm - i * sm
            ls = l0 + PER * tid[:, None] + torch.arange(PER)  # (THREADS, PER)
            live = ls < out_len
            mu_l = torch.where(live, mu[m, ls.clamp(max=out_len - 1)], 0.0)
            w = []
            for t in range(TAPS):
                v = torch.full_like(mu_l, float(coef[t, 0]))
                for d in range(1, coef.shape[1]):
                    v = v * mu_l + coef[t, d]
                w.append(v)
            for plane in range(2):
                acc = [None] * PER
                for ch in range(CHUNKS):
                    for jj in range(4):
                        v = rot[plane][:, PER * tid + 4 * ch + jj]
                        for k in range(PER):
                            t = 4 * ch + jj - k
                            if 0 <= t < TAPS:
                                prod = v * w[t][:, k]
                                acc[k] = prod if t == 0 else acc[k] + prod
                for k in range(PER):
                    keep = live[:, k]
                    out[plane, :, m, ls[keep, k]] = acc[k][:, keep]
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out[0], out[1]


def _raw(f, n_in, seed, interleaved=False):
    """Random raw planes with a DC offset and unequal rails."""
    gen = torch.Generator().manual_seed(seed)
    raw = torch.randn((f, n_in, 2), generator=gen) * torch.tensor([0.3, 0.28])
    raw = raw + torch.tensor([0.01, -0.007])
    if interleaved:
        return raw
    return raw[..., 0].contiguous(), raw[..., 1].contiguous()


# callers of the corrector at small shapes: name -> (the front end's
# factory, raw length, track (cfo, ratio, pos0, phase0), interleaved input)
def _symbols(out_dtype=None):
    return fd.make_frontend_symbols(3, 3000, 200, FS, p1_len=500, half=HALF,
                                    sym_order=[2, 0, 1], out_dtype=out_dtype)


CASES = {
    "symbols": (_symbols, 9700, (900.0, 1 + SCO, HALF * (1 + SCO), 0.1),
                False),
    "symbols-bf16": (lambda: _symbols(torch.bfloat16), 9700,
                     (900.0, 1 + SCO, HALF * (1 + SCO), 0.1), False),
    # the raw planes end inside the last symbol: reads past n_in
    "symbols-short": (_symbols, 8800, (-700.0, 1 - SCO, HALF, 2.0), False),
    # the first symbol's stencil starts left of sample 0: a negative start
    "left-edge": (lambda: fd.make_frontend_symbols(
        3, 1000, 4, FS, p1_len=0, half=HALF, sym_order=[1, 2, 0]), 3200,
        (900.0, 1 + SCO, 0.0, 0.1), False),
    # 3 chunks of 2048 for 5000 outputs, read from interleaved (F, n, 2)
    "chunks": (lambda: fd.make_frontend(5000, FS, half=HALF, chunk=2048),
               5060, (1200.0, 1 + SCO, HALF * (1 + SCO), 0.3), True),
}


def _calls(case):
    """Run case `case` on the CPU with its corrector's `plain` recorded.
    -> (corrector, its recorded arguments, its output, the frontend's)."""
    build, n_in, track, interleaved = CASES[case]
    fe = build()
    corr = fe.correct
    seen = []

    def plain(*a):
        out = type(corr).plain(corr, *a)
        seen.append((a, out))
        return out

    corr.plain = plain
    try:
        if interleaved:
            res = fe(_raw(2, n_in, 5, True), *track)
        else:
            res = fe(*_raw(2, n_in, 5), *track)
    finally:
        del corr.plain
    (args, out), = seen
    return corr, args, out, res


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_is_the_corrector_before(case):
    corr, args, out, _ = _calls(case)
    raw_r, raw_i, pad, s, mu, est, nco, out_dtype = args
    if case == "left-edge":
        assert int(s.min()) < 0
    pad_r = torch.nn.functional.pad(raw_r, (0, pad))
    pad_i = torch.nn.functional.pad(raw_i, (0, pad))
    want = _correct_before(corr.out_len, corr.slice_len, corr.cf)(
        pad_r, pad_i, s, mu, est, nco)
    if out_dtype is not None:
        want = tuple(v.to(out_dtype) for v in want)
    for got, ref in zip(out, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_equals_plain(case):
    corr, args, out, _ = _calls(case)
    raw_r, raw_i, pad, s = args[:4]
    n_in = raw_r.shape[1]
    starts = fd._window_starts(s, n_in + pad, corr.slice_len)
    if case in ("symbols-short", "chunks"):   # some windows read past n_in
        assert int(starts.max()) + corr.slice_len > n_in
    if case == "chunks":
        assert corr.out_len % TL == 0 and raw_r.stride() == (2 * n_in, 2)
    else:
        assert corr.out_len % TL != 0        # a partial last tile
    got = _emulate_k8(corr, *args)
    for g, want in zip(got, out):
        assert torch.equal(g, want)


def test_cpu_takes_plain_and_the_kernel_refuses_cpu_tensors():
    before = fd.frontend_correct_cuda.launches
    TRACER.clear()
    TRACER.enable()
    try:
        corr, args, out, _ = _calls("symbols")
    finally:
        TRACER.disable()
    assert fd.frontend_correct_cuda.launches == before
    assert TRACER.counters()["frontend.kernel_frames"] == 0
    TRACER.clear()
    with pytest.raises(ValueError):
        corr.kernel(*args)


def test_the_wrappers_table_names_k8():
    from sdr_receiver_dvb_t2_tpu_torch.ops import kernel_wrappers
    assert kernel_wrappers()["K8"] is fd.frontend_correct_cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K8 has no CPU mode)")


def _kernel_and_plain(fe, raw, track):
    """The frontend on the card through K8, then through the plain
    version. -> (K8's result, plain's result, K8's launches)."""
    before = fd.frontend_correct_cuda.launches
    got = fe(*raw, *track)
    n = fd.frontend_correct_cuda.launches - before
    fe.correct.kernel = fe.correct.plain
    try:
        want = fe(*raw, *track)
    finally:
        del fe.correct.kernel
    torch.cuda.synchronize()
    return got, want, n


@pytest.mark.cuda
def test_k8_equals_plain_at_the_uk_hd_step():
    """The superstep's front end at the cells' mode (32K, GI 1/128, 60
    windows of 32768), F=64, bf16 out, symbols in a permuted order."""
    _card()
    p, _ = benchgen.headline_mode(202)
    order = np.random.default_rng(3).permutation(p.len_frame)
    fe = fd.make_frontend_symbols(p.len_frame, p.symbol_size, p.guard_size,
                                  FS, half=HALF, sym_order=order,
                                  out_dtype=torch.bfloat16)
    n_in = fd.frontend_raw_len(p.frame_samples, SCO, HALF)
    gen = torch.Generator(device="cuda").manual_seed(8)
    raw = [torch.randn((64, n_in), generator=gen, device="cuda") * 0.3 + dc
           for dc in (0.01, -0.007)]
    track = [torch.tensor(v, device="cuda") for v in
             (1200.0, 1 + SCO, HALF * (1 + SCO), 0.35)]
    got, want, n = _kernel_and_plain(fe, raw, track)
    assert n == 1
    (gr, gi), gdc, ggiq = got
    (wr, wi), wdc, wgiq = want
    assert gr.shape == (64, p.len_frame, p.fft_size)
    assert gr.dtype == torch.bfloat16 and gr.is_contiguous()
    assert torch.equal(gr, wr) and torch.equal(gi, wi)
    assert torch.equal(gdc, wdc) and torch.equal(ggiq, wgiq)


@pytest.mark.cuda
def test_k8_equals_plain_chunked_f32():
    """`make_frontend` as `entry.py` builds it: chunks of 16384 outputs of
    a whole UK HD frame body, f32, read from interleaved (F, n, 2) input."""
    _card()
    p, _ = benchgen.headline_mode(202)
    n_out = p.len_frame * p.symbol_size
    fe = fd.make_frontend(n_out, FS, chunk=16384)
    n_in = fd.frontend_raw_len(n_out, SCO, HALF)
    gen = torch.Generator(device="cuda").manual_seed(9)
    raw = torch.randn((4, n_in, 2), generator=gen, device="cuda") * 0.3
    got, want, n = _kernel_and_plain(fe, [raw],
                                     (-800.0, 1 - SCO, 8.0, 0.2))
    assert n == 1
    assert got[0].shape == (4, n_out, 2) and got[0].dtype == torch.float32
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_superstep_launches_k8_once_for_its_frames():
    _card()
    from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as tss
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=3,
                    time_il_length=1, rotated=True)
    f = 64
    step = tss.Superstep(p, plp, 3, f, FS,
                         tss.hash_weights(plp.fec.k_bch // 8, 3))
    n_in = fd.frontend_raw_len(p.frame_samples, SCO, HALF)
    gen = torch.Generator(device="cuda").manual_seed(10)
    raw_r, raw_i = (torch.randn((f, n_in), generator=gen, device="cuda")
                    for _ in range(2))
    track = torch.tensor([0.0, 1.0, float(HALF), 0.0], device="cuda")
    before = fd.frontend_correct_cuda.launches
    TRACER.clear()
    TRACER.enable()
    try:
        step(raw_r, raw_i, 30.0, track)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    assert fd.frontend_correct_cuda.launches == before + 1
    assert TRACER.counters()["frontend.kernel_frames"] == f
    TRACER.clear()
