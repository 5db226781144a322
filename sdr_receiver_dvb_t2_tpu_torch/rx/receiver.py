"""T2Receiver: IQ sample stream -> MPEG transport stream.

Two-phase receive (SURVEY.md §7):
  1. acquire: P1 search/decode on a prefix (host) -> FFT mode + coarse CFO;
     demod first frame's P2 -> L1-pre/L1-post -> full T2Params/PLPParams.
  2. decode: per frame, batched carrier extraction + equalization +
     deinterleave + FEC -> TS (optionally via a JAX device path).

Equivalent of the reference's 7-thread pipeline collapsed into pure batched
functions (dvbt2_demodulator.cpp + the decode chain)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..dvbt2 import bbframe, l1 as l1mod
from ..dvbt2.params import Bandwidth, T2Params, PLPParams, SAMPLE_RATE
from ..utils.metrics import span
from . import decode as rxdecode
from . import demod as rxdemod
from . import p1_detect as rxp1


@dataclass
class ReceiverStats:
    frames_decoded: int = 0
    snr_db: list = field(default_factory=list)
    timing_offset: list = field(default_factory=list)
    sco_ppm: float = 0.0
    cfo_hz: float = 0.0
    l1_failures: int = 0
    plp_stats: dict = field(default_factory=dict)
    ts_errors: int = 0
    ts_packets: int = 0
    last_cells: np.ndarray | None = None   # most recent equalized cells
    last_cells_label: str = ""             # which stage they came from


@dataclass
class LockState:
    """Acquisition result for a streaming consumer: the transmission mode
    plus the residual corrections measured on (not yet applied to) the
    acquisition buffer.  The streaming loop applies cfo/sco through its
    StreamCorrector and then tracks per frame."""
    params: T2Params
    plps: list
    l1pre: l1mod.L1Pre
    l1post: l1mod.L1Post
    frame_start: int      # index of the first frame's P1 in the buffer seen
    cfo_hz: float         # residual CFO measured on that buffer
    sco: float            # residual fractional sample-clock offset
    snr_db: float
    fail_streak: int = 0  # consecutive tracking failures (unlock gate)
    frame_idx: int = 0    # L1 FRAME_IDX of the frame at frame_start; the
    # streaming tracker advances it per frame to schedule around FEF parts


@dataclass
class ReceiveResult:
    ts: np.ndarray
    stats: ReceiverStats
    params: T2Params | None = None
    l1pre: l1mod.L1Pre | None = None
    l1post: l1mod.L1Post | None = None


class T2Receiver:
    """Config = {input samples, optional PLP filter}; everything else is
    discovered from the signal (the reference's auto-derivation property,
    SURVEY.md §5 config)."""

    def __init__(self, plp_filter: int | None = None,
                 ldpc_decode_fn_factory=None, profile: str = "base",
                 fs: float = SAMPLE_RATE):
        self.plp_filter = plp_filter
        # true elementary rate in Hz: SAMPLE_RATE for 8 MHz channels, the
        # bandwidth's rate otherwise (params.Bandwidth; t2rx --bandwidth).
        # Only the Hz boundaries depend on it — CFO reporting/derotation
        # and retune feedback; the sample-domain demod is bandwidth-blind.
        self.fs = float(fs)
        # factory: (plp: PLPParams) -> batched decoder fn, or None
        self.ldpc_decode_fn_factory = ldpc_decode_fn_factory
        # which preamble types this receiver selects: "base" locks on T2
        # P1s, "lite" on T2-Lite P1s — a T2-Lite service multiplexed into
        # the base signal's FEF parts is received with profile="lite"
        # (the reference supports neither T2-Lite nor FEF)
        if profile not in ("base", "lite"):
            raise ValueError(f"profile must be base|lite, got {profile!r}")
        self.profile = profile
        self._accept = (rxp1.LITE_PREAMBLES if profile == "lite"
                        else rxp1.BASE_PREAMBLES)
        self._last_l1post = None
        self._inband_prev = {}   # plp_id -> last frame's InBandA (or None)
        # optional T2-MI regenerator (tx.t2mi.T2MIRegenerator): observes
        # each decoded frame's L1 + BB frames from the numpy decode path
        # (the DVB regenerative-repeater role, L1-pre regen_flag)
        self.regen_sink = None

    def receive(self, x: np.ndarray, _sco_pass: int = 2,
                _ladder: bool = True) -> ReceiveResult:
        stats = ReceiverStats()
        self._inband_prev = {}
        x = np.asarray(x)
        p1 = rxp1.acquire_p1(x, accept=self._accept, fs=self.fs)
        if p1 is None:
            return ReceiveResult(ts=np.zeros(0, np.uint8), stats=stats)
        cfo = p1.fractional_cfo_hz \
            + p1.integer_cfo_carriers * self.fs / rxp1.P1_A
        stats.cfo_hz = cfo
        if abs(cfo) > 1e-3:
            n = np.arange(len(x))
            x = x * np.exp(-2j * np.pi * cfo * n / self.fs)

        # bootstrap params: enough to demod a P2 symbol we can parse L1 from.
        # GI is unknown before L1-pre; like the reference we try GI candidates
        # (set_guard_interval_by_brute_force) but can validate instantly on
        # the recorded block via the L1-pre CRC.
        scan = self._scan_mode(x, p1)
        params, l1pre = scan if scan is not None else (None, None)
        if params is None:
            # acquisition failed outright: a large sample-clock offset can
            # smear the carriers enough to break even hard-decision L1.
            # Try a ladder of trial resample ratios (the recorded-block
            # analogue of the reference slowly pulling its resampler in);
            # the fine SCO measurement below then converges the residue.
            if _ladder:
                ladder = self._sco_ladder(x)
                if ladder is not None:
                    return ladder
            stats.l1_failures += 1
            return ReceiveResult(ts=np.zeros(0, np.uint8), stats=stats)

        # full first-frame demod with correct params, parse L1-post.
        # The P1 correlator peak can land a sample or two late; when the
        # capture ends exactly at the frame grid that overshoot would lose
        # the whole frame — start the FFT windows early instead, which the
        # guard interval absorbs (same clamp as the streaming tracker,
        # io.devices.StreamingReceiver.track_one)
        over = p1.start + params.frame_samples - len(x)
        if over > 0:
            if over <= min(32, params.guard_size // 2) and p1.start >= over:
                p1.start -= over
            else:
                stats.l1_failures += 1
                return ReceiveResult(ts=np.zeros(0, np.uint8), stats=stats,
                                     params=params, l1pre=l1pre)
        body = p1.start + rxp1.P1_LEN
        carriers = rxdemod.extract_carriers(params, x, body)
        dres = rxdemod.equalize_frame(params, carriers)
        l1_cells = dres.frame_cells[l1mod.L1_PRE_CELLS:
                                    l1mod.L1_PRE_CELLS + l1pre.l1_post_size]
        l1post = l1mod.l1post_decode_hard(l1_cells, l1pre)
        if l1post is None:
            # soft fallback: use the L1 LDPC parity the reference discards
            nvar = 10.0 ** (-min(dres.snr_db, 35.0) / 10.0)
            l1post = l1mod.l1post_decode_soft(l1_cells, l1pre, nvar=nvar)
        if l1post is None:
            if _ladder:
                ladder = self._sco_ladder(x)
                if ladder is not None:
                    return ladder
            stats.l1_failures += 1
            return ReceiveResult(ts=np.zeros(0, np.uint8), stats=stats,
                                 params=params, l1pre=l1pre)
        params, plps = rxdecode.params_from_l1(
            p1.fft_mode, l1pre, l1post,
            bandwidth=Bandwidth.from_rate(self.fs))

        # fine CFO from guard-interval correlation: the P1 readout is
        # only good to a few tens of Hz, which large FFT modes cannot
        # tolerate (at 32K, 29 Hz is ~10% of the carrier spacing — ICI
        # near -15 dB); the reference closes this with its per-symbol
        # fine frequency loop (dvbt2_demodulator.cpp:321-330)
        fine = rxdemod.gi_fine_cfo(params, x, p1.start, self.fs)
        if abs(fine) > 1.0:
            n = np.arange(len(x))
            x = x * np.exp(-2j * np.pi * fine * n / self.fs)
            stats.cfo_hz += fine

        # sample-clock-offset measurement: locate the next frame's P1 and
        # compare the spacing with the nominal frame length; a material
        # offset means the capture clock is off (the reference closes this
        # loop through its Farrow resampler at +-8e-9/symbol,
        # dvbt2_demodulator.cpp:430-439) -- we measure feed-forward and
        # resample the whole block once, then re-acquire.
        if _sco_pass:
            sco = self._measure_sco(x, p1.start, params, dres.timing_offset,
                                    frame_idx0=l1post.dyn.frame_idx,
                                    n_t2=l1pre.num_t2_frames)
            if 2e-6 < abs(sco) < 5e-3:
                from . import frontend
                # zero headroom: repeated resampling walks the first
                # P1 a few samples earlier each pass; keep it in-buffer
                x2 = np.concatenate(
                    [np.zeros(512, x.dtype),
                     frontend.sinc_resample(x, 1.0 + sco)])
                # a second pass converges the estimator's bias at
                # large residuals (the pilot-slope measurement is a
                # few % off at ~100 ppm); reported ppm accumulates
                res = self.receive(x2, _sco_pass=_sco_pass - 1)
                res.stats.cfo_hz = stats.cfo_hz
                res.stats.sco_ppm = sco * 1e6 + res.stats.sco_ppm
                return res

        assembler = bbframe.TSAssembler()
        frame_start = p1.start
        frame_idx = 0
        idx0 = l1post.dyn.frame_idx  # absolute L1 FRAME_IDX of frame 0
        n_t2 = max(int(l1pre.num_t2_frames), 1)
        self._last_l1post = l1post
        while frame_start + params.frame_samples <= len(x):
            ok = self._decode_frame(x, frame_start, params, plps, l1pre,
                                    l1post if frame_idx == 0 else None,
                                    assembler, stats)
            if not ok:
                break
            frame_idx += 1
            # FEF parts sit between T2-frames (clause 8.3.1): the stride to
            # the next frame start includes the signalled FEF_LENGTH after
            # every FEF_INTERVAL-th frame.  FRAME_IDX wraps at
            # NUM_T2_FRAMES on air — mirror it (matters when NUM_T2_FRAMES
            # is not a multiple of FEF_INTERVAL)
            frame_start += params.frame_samples \
                + params.fef_after((idx0 + frame_idx - 1) % n_t2)
            # sample-clock-offset retiming: when the pilot-slope timing
            # estimate shows the windows drifting (the reference nudges its
            # Farrow resampler +-8e-9/symbol instead,
            # dvbt2_demodulator.cpp:430-439) step the next frame start by
            # whole samples; fractional residue is absorbed by the
            # per-symbol channel estimate
            # (gated on a sane pilot SNR: a corrupted frame's slope estimate
            # is garbage and would mis-step the grid for the NEXT frame)
            if (stats.timing_offset and abs(stats.timing_offset[-1]) > 2.0
                    and stats.snr_db[-1] > 10.0):
                frame_start += int(round(stats.timing_offset[-1]))
        stats.ts_errors = assembler.error_count()
        stats.ts_packets = len(assembler.packets)
        return ReceiveResult(ts=assembler.ts_bytes(), stats=stats,
                             params=params, l1pre=l1pre, l1post=l1post)

    def _scan_mode(self, x, p1):
        """GI/PP/ext brute-force scan gated by the L1-pre CRC (the
        reference's set_guard_interval_by_brute_force,
        dvbt2_demodulator.cpp:481-545).  Returns (params, l1pre) or None."""
        from ..dvbt2.params import GuardInterval
        with span("t2.acquire.scan_mode"):
            for gi in (GuardInterval.GI_1_128, GuardInterval.GI_1_32,
                       GuardInterval.GI_1_16, GuardInterval.GI_19_256,
                       GuardInterval.GI_1_8, GuardInterval.GI_19_128,
                       GuardInterval.GI_1_4):
                for ext in (True, False):
                    for pp in range(8):
                        cand = self._try_l1pre(x, p1, gi, ext, pp)
                        if cand is not None:
                            return cand
        return None

    def _measure_sco(self, x, p1_start, params, t0,
                     frame_idx0: int = 0, n_t2: int = 1 << 30) -> float:
        """Sample-clock offset from the pilot-slope timing drift between
        consecutive frames (sub-sample precision); 0.0 when the buffer is
        too short or two gap estimates disagree (corrupted frame guard).
        Frame gaps include any FEF parts between them (FRAME_IDX wraps at
        NUM_T2_FRAMES like the on-air field)."""
        nominal = params.frame_samples
        n_t2 = max(int(n_t2), 1)
        gap1 = nominal + params.fef_after(frame_idx0 % n_t2)
        gap2 = nominal + params.fef_after((frame_idx0 + 1) % n_t2)
        if p1_start + gap1 + nominal > len(x):
            return 0.0
        car1 = rxdemod.extract_carriers(
            params, x, p1_start + gap1 + rxp1.P1_LEN)
        t1 = rxdemod.equalize_frame(params, car1).timing_offset
        sco = (t1 - t0) / gap1
        if p1_start + gap1 + gap2 + nominal <= len(x):
            # a corrupted frame gives a garbage slope; demand two
            # consistent frame-gap estimates before acting on it
            car2 = rxdemod.extract_carriers(
                params, x, p1_start + gap1 + gap2 + rxp1.P1_LEN)
            t2 = rxdemod.equalize_frame(params, car2).timing_offset
            sco_b = (t2 - t1) / gap2
            if not (abs(sco_b - sco) < 0.3 * max(abs(sco), abs(sco_b))):
                return 0.0
        return float(sco)

    def acquire(self, x: np.ndarray) -> "LockState | None":
        """Acquisition WITHOUT decoding: P1 search -> mode scan -> L1 parse
        -> SCO measurement, reporting the residual corrections instead of
        applying them.  The streaming consumer (io.devices.StreamingReceiver)
        owns the correction state (NCO phase, resampler position) so locks
        survive block boundaries; `receive` stays the one-shot whole-buffer
        entry point."""
        x = np.asarray(x)
        p1 = rxp1.acquire_p1(x, accept=self._accept, fs=self.fs)
        if p1 is None:
            return None
        cfo = p1.fractional_cfo_hz \
            + p1.integer_cfo_carriers * self.fs / rxp1.P1_A
        if abs(cfo) > 1e-3:
            n = np.arange(len(x))
            x = x * np.exp(-2j * np.pi * cfo * n / self.fs)
        scan = self._scan_mode(x, p1)
        if scan is None:
            return None
        params, l1pre = scan
        over = p1.start + params.frame_samples - len(x)
        if over > 0:
            # P1-peak jitter at the very end of the buffer: start the FFT
            # windows early, the guard interval absorbs it
            if over <= min(32, params.guard_size // 2) and p1.start >= over:
                p1.start -= over
            else:
                return None
        carriers = rxdemod.extract_carriers(params, x,
                                            p1.start + rxp1.P1_LEN)
        dres = rxdemod.equalize_frame(params, carriers)
        l1_cells = dres.frame_cells[l1mod.L1_PRE_CELLS:
                                    l1mod.L1_PRE_CELLS + l1pre.l1_post_size]
        l1post = l1mod.l1post_decode_hard(l1_cells, l1pre)
        if l1post is None:
            nvar = 10.0 ** (-min(dres.snr_db, 35.0) / 10.0)
            l1post = l1mod.l1post_decode_soft(l1_cells, l1pre, nvar=nvar)
        if l1post is None:
            return None
        params, plps = rxdecode.params_from_l1(
            p1.fft_mode, l1pre, l1post,
            bandwidth=Bandwidth.from_rate(self.fs))
        sco = self._measure_sco(x, p1.start, params, dres.timing_offset,
                                frame_idx0=l1post.dyn.frame_idx,
                                n_t2=l1pre.num_t2_frames)
        self._last_l1post = l1post
        # guard-interval fine CFO on top of the P1 readout (see receive):
        # the streaming loop applies the reported value to its NCO, so
        # large-FFT modes need the ~Hz-grade refinement here too
        fine = rxdemod.gi_fine_cfo(params, x, p1.start, self.fs)
        return LockState(params=params, plps=plps, l1pre=l1pre,
                         l1post=l1post, frame_start=int(p1.start),
                         cfo_hz=float(cfo + fine), sco=float(sco),
                         snr_db=float(dres.snr_db),
                         frame_idx=int(l1post.dyn.frame_idx))

    def refine_acquire(self, x: np.ndarray, max_rounds: int = 4):
        """Acquire + apply the streaming refine sequence on a host buffer:
        derotate by the measured CFO, resample by the measured SCO,
        re-acquire, until both residuals are small or `max_rounds` is
        exhausted (the io/devices.py _acquire loop, shared so the bench
        and the distributed children don't re-implement it).

        Returns (ls, cfo_total_hz, ratio_total, xc) — the final lock
        state measured on the corrected buffer `xc`, with the TOTAL
        accumulated corrections.  Residuals already folded into the
        accumulators are zeroed on `ls`, so the caller cannot double
        count them (a 4-round exhaustion used to re-add the last
        applied correction).  (None, 0.0, 1.0, x) when acquisition
        never locks.  Traced as the span "t2.acquire", a
        "t2.acquire.round" per round and "t2.acquire.scan_mode" inside
        (`utils.metrics.span`)."""
        from . import frontend
        cfo_acc, ratio_acc = 0.0, 1.0
        ls = None
        with span("t2.acquire"):
            for _ in range(max_rounds):
                with span("t2.acquire.round"):
                    ls = self.acquire(x)
                    if ls is None:
                        return None, cfo_acc, ratio_acc, x
                    if abs(ls.cfo_hz) > 2.0:
                        n = np.arange(len(x))
                        x = (x * np.exp(-2j * np.pi * ls.cfo_hz * n
                                        / self.fs)).astype(np.complex64)
                        cfo_acc += ls.cfo_hz
                        ls.cfo_hz = 0.0
                        continue
                    if abs(ls.sco) > 2e-7:
                        x = frontend.sinc_resample(x, 1.0 + ls.sco)
                        ratio_acc *= (1.0 + ls.sco)
                        ls.sco = 0.0
                        continue
                    break
        return (ls, cfo_acc + ls.cfo_hz,
                ratio_acc * (1.0 + ls.sco), x)

    def _sco_ladder(self, x):
        """Trial resample ratios for large sample-clock offsets (the
        recorded-block analogue of the reference slowly pulling its
        resampler in); the fine P1-spacing measurement converges the
        residue on the successful branch."""
        from . import frontend
        for trial in (40e-6, -40e-6, 100e-6, -100e-6, 180e-6, -180e-6):
            xr = np.concatenate(
                [np.zeros(512, x.dtype),
                 frontend.sinc_resample(x, 1.0 + trial)])
            res = self.receive(xr, _ladder=False)
            if res.stats.frames_decoded > 0:
                res.stats.sco_ppm += trial * 1e6
                return res
        return None

    def _try_l1pre(self, x, p1, gi, ext, pp):
        """Candidate-GI demod of the first P2 symbol -> L1-pre CRC gate."""
        from ..dvbt2.params import PilotPattern
        try:
            cand = T2Params(fft_mode=p1.fft_mode, guard=gi,
                            pilot_pattern=PilotPattern(pp),
                            extended_carrier=ext, miso=p1.s1 in (1, 4),
                            preamble=p1.preamble)
            _ = cand.c_data  # raises on illegal combos
        except (ValueError, KeyError):
            return None
        body = p1.start + rxp1.P1_LEN
        if body + cand.symbol_size > len(x):
            return None
        g, n = cand.guard_size, cand.fft_size
        sym = x[body + g:body + g + n]
        spec = np.fft.fftshift(np.fft.fft(sym))
        row = spec[cand.left_nulls:cand.left_nulls + cand.k_total]
        cells = rxdemod.equalize_p2_symbol(cand, row)
        pre = l1mod.l1pre_decode_hard(cells[:l1mod.L1_PRE_CELLS])
        if pre is None:
            return None
        # adopt the mode L1-pre declares (GI/PP/ext may differ from the
        # candidate only in ways that didn't corrupt the P2 demod)
        from ..dvbt2.params import GuardInterval, PAPR
        try:
            params = T2Params(
                fft_mode=p1.fft_mode,
                guard=GuardInterval(pre.guard_interval),
                pilot_pattern=PilotPattern(pre.pilot_pattern),
                extended_carrier=bool(pre.bwt_ext),
                papr=PAPR(pre.papr) if pre.papr in (0, 1, 2, 3) else PAPR.OFF,
                miso=p1.s1 in (1, 4),
                preamble=p1.preamble,
                n_data=pre.num_data_symbols,
                # bandwidth is not signalled: tag the discovered mode with
                # the declared elementary rate when it matches a standard BW
                bandwidth=Bandwidth.from_rate(self.fs) or Bandwidth.BW_8)
            _ = params.c_data
        except (ValueError, KeyError):
            return None
        return params, pre

    def _inband_patched(self, l1post):
        """Patch a stale L1-post's dynamic block from the previous frame's
        in-band type-A payloads: each carries this frame's start/num_blocks
        for its own PLP (current_*) and for the other signalled PLPs
        (other_plp loop)."""
        import dataclasses as _dc
        sched = {}
        for pid, ib in self._inband_prev.items():
            if ib is None:
                continue
            sched[pid] = (ib.current_plp_start, ib.current_plp_num_blocks)
            for o in ib.other_plp:
                sched.setdefault(o.id, (o.start, o.num_blocks))
        if not sched:
            return l1post
        newplp = [(_dc.replace(dp, start=sched[dp.id][0],
                               num_blocks=sched[dp.id][1])
                   if dp.id in sched else dp) for dp in l1post.dyn.plp]
        return _dc.replace(l1post, dyn=_dc.replace(l1post.dyn, plp=newplp))

    def _decode_frame(self, x, frame_start, params, plps, l1pre,
                      l1post_cached, assembler, stats) -> bool:
        body = frame_start + rxp1.P1_LEN
        carriers = rxdemod.extract_carriers(params, x, body)
        dres = rxdemod.equalize_frame(params, carriers)
        stats.snr_db.append(dres.snr_db)
        stats.timing_offset.append(dres.timing_offset)
        if l1post_cached is not None:
            l1post = l1post_cached
        else:
            cells_l1 = dres.frame_cells[l1mod.L1_PRE_CELLS:
                                        l1mod.L1_PRE_CELLS
                                        + l1pre.l1_post_size]
            l1post = l1mod.l1post_decode_hard(cells_l1, l1pre)
            if l1post is None:
                nvar = 10.0 ** (-min(dres.snr_db, 35.0) / 10.0)
                l1post = l1mod.l1post_decode_soft(cells_l1, l1pre, nvar=nvar)
            if l1post is None:
                # CRC failed this frame: fall back to the previous frame's
                # L1 (instead of the reference's full reset,
                # dvbt2_demodulator.cpp:418-425 -- on a recorded block we
                # can keep decoding).  With L1 repetition the previous
                # frame carried THIS frame's dynamic block (dyn_next,
                # clause 7.2.3.1) -- use it; otherwise assume CCM-style
                # constant scheduling and reuse the last dynamic.
                stats.l1_failures += 1
                l1post = self._last_l1post
                if l1post is None:
                    return False
                if l1post.dyn_next is not None:
                    import dataclasses as _dc
                    l1post = _dc.replace(l1post, dyn=l1post.dyn_next)
                else:
                    # in-band type-A fallback: the PREVIOUS frame's in-band
                    # payload signalled THIS frame's scheduling
                    # (clause 5.2.3) — its purpose: track dynamic scheduling
                    # without decoding L1-post every frame
                    l1post = self._inband_patched(l1post)
            else:
                self._last_l1post = l1post
        data_cells = dres.frame_cells[l1mod.L1_PRE_CELLS
                                      + l1pre.l1_post_size:]
        if self.regen_sink is not None:
            self.regen_sink.start_frame(params, l1pre, l1post)
        # live-view tap (the GUI constellation feed, main_window.cpp:393-441)
        stride = max(1, len(data_cells) // 1024)
        stats.last_cells = np.array(data_cells[::stride][:1024])
        stats.last_cells_label = "data cells (eq)"
        for plp, dyn in zip(plps, l1post.dyn.plp):
            if (self.plp_filter is not None and dyn.id != self.plp_filter) \
                    or dyn.num_blocks == 0:
                # skipped this frame: no in-band payload was recovered, so
                # a later frame must not be checked against an older one's
                # next-frame schedule
                if plp.in_band_a:
                    self._inband_prev[dyn.id] = None
                continue
            pstat = stats.plp_stats.setdefault(
                dyn.id, rxdecode.PLPDecodeStats())
            # in-band type-A coherence: the PREVIOUS frame signalled this
            # frame's scheduling (clause 5.2.3); a disagreement with the
            # decoded L1 dynamic marks one of them corrupted
            ib_prev = self._inband_prev.get(dyn.id)
            if ib_prev is not None and (
                    ib_prev.current_plp_start != dyn.start
                    or ib_prev.current_plp_num_blocks != dyn.num_blocks):
                pstat.inband_mismatches += 1
            n_cells = dyn.num_blocks * plp.cells_per_fec_block
            if plp.plp_type == 2 and plp.sub_slices > 1:
                # type-2 PLP: gather the round-robin sub-slices back into
                # one cell stream (the reference's slice switching,
                # time_deinterleaver.cpp:354-366)
                ln = n_cells // plp.sub_slices
                iv = l1post.dyn.sub_slice_interval
                sl = np.concatenate(
                    [data_cells[dyn.start + r * iv:
                                dyn.start + r * iv + ln]
                     for r in range(plp.sub_slices)])
            else:
                sl = data_cells[dyn.start:dyn.start + n_cells]
            fn = (self.ldpc_decode_fn_factory(plp)
                  if self.ldpc_decode_fn_factory else None)
            sink = None
            fails0 = pstat.ldpc_failures + pstat.bch_failures
            if self.regen_sink is not None:
                sink = (lambda bb, pid=dyn.id:
                        self.regen_sink.add_bb(pid, bb))
            ib = rxdecode.plp_slice_to_ts(
                plp, sl, dyn.num_blocks,
                assembler.stream(dyn.id if len(plps) > 1 else None),
                stats=pstat, ldpc_decode_fn=fn, bb_sink=sink)
            if (self.regen_sink is not None
                    and pstat.ldpc_failures + pstat.bch_failures > fails0):
                # FEC did not fully converge on this frame: the regenerated
                # feed must not re-emit corrupted BB frames as clean
                self.regen_sink.mark_bad()
            if plp.in_band_a:
                self._inband_prev[dyn.id] = ib
        stats.frames_decoded += 1
        return True
