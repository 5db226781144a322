"""DeviceT2Receiver: the high-level receiver with its bulk path in PyTorch
on a `torch.device` (fused demod + LLRs + the layered LDPC kernels), and
acquisition, L1 parsing, the BCH tail and TS reassembly on the host.

Port of `sdr_receiver_dvb_t2_tpu/rx/device_receiver.py`.  It subclasses
the port's host `T2Receiver` (`rx/receiver.py`: acquisition, SCO retiming
and the frame loop of `receive()`), replaces the per-frame decode with the
device path and adds the F-frame batched path the streaming loop calls
(`decode_frames_batch`).  The device path is keyed by (mode, PLP,
num_blocks) and built once per configuration.

Decoders, by the JAX receiver's rule (`_get_decoder`): a batch that is a
multiple of 128 codewords takes the adaptive layered decoder K2 (check
every 2 sweeps, reversed layers) or, with adaptive=False, the fixed
decoder `make_decoder_nb` (K3, or K4 where the JAX `vmem_fit_bytes` rule
says so) at max(10, ldpc_max_iters // 2) sweeps; any other batch takes the
bf16 flooding decoder.  That rule comes from the TPU's 128-lane batches;
the port keeps it so that it decodes every capture as the JAX receiver
does.  On a CUDA device the layered decoders launch their CUDA kernels; on
the CPU they run their plain PyTorch versions.

Streaming front end: `wants_device_frontend` is True, so the streaming
loop (`io/devices.StreamingReceiver`) corrects samples on this receiver's
device with `ops/frontend_device.DeviceFrontendChain`, and keeps the host
`CorrectorChain` only for a rate ratio that chain refuses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dvbt2 import bbframe, inband, l1 as l1mod
from ..dvbt2.params import (PLPParams, SAMPLE_RATE,
                                                  T2Params)
from ..ops import fec_device
from ..rx import decode as rxdecode
from ..rx import p1_detect as rxp1
from ..rx.receiver import T2Receiver

from ..ops import ldpc as fldpc
from ..ops import ldpc_layered as qldpc
from . import fusedpath


class DeviceT2Receiver(T2Receiver):
    def __init__(self, plp_filter: int | None = None,
                 ldpc_max_iters: int = 24, adaptive: bool = True,
                 stream_batch: int = 4, profile: str = "base",
                 fs: float | None = None, *, device="cuda"):
        super().__init__(plp_filter=plp_filter, profile=profile,
                         fs=SAMPLE_RATE if fs is None else fs)
        self.device = torch.device(device)
        self.ldpc_max_iters = ldpc_max_iters
        self.adaptive = adaptive
        self.wants_device_frontend = True
        # F-frame superstep size for the streaming loop: it calls
        # decode_frames_batch whenever this many tracked frames are pending
        self.stream_batch = stream_batch
        self.batch_supersteps = 0
        self._paths: dict = {}
        self._mf_paths: dict = {}
        self._decoders: dict = {}
        self._nvar: float | None = None

    def _get_path(self, params: T2Params, plp: PLPParams, num_blocks: int,
                  l1_cells: int, start_cell: int, sub_slices: int = 1,
                  slice_interval: int = 0) -> fusedpath.FusedPLPPath:
        key = (params, plp, num_blocks, l1_cells, start_cell,
               sub_slices, slice_interval)
        if key not in self._paths:
            demod = fusedpath.get_fused_demod(params)
            self._paths[key] = fusedpath.FusedPLPPath(
                params, plp, num_blocks, demod,
                plp_start_cell=start_cell, l1_cells=l1_cells,
                sub_slices=sub_slices, slice_interval=slice_interval)
        return self._paths[key]

    @staticmethod
    def _slicing(plp: PLPParams, l1post):
        """(sub_slices, slice_interval) of a PLP under the decoded dynamic
        (type-2 round-robin slice switching, clause 8.3.6.3)."""
        ss = plp.sub_slices if plp.plp_type == 2 else 1
        iv = l1post.dyn.sub_slice_interval if ss > 1 else 0
        return ss, iv

    def _get_decoder(self, plp: PLPParams, batch: int):
        """-> (kind, decoder): "nb_adaptive" (K2), "nb" (K3/K4) or
        "flood", by the JAX receiver's rule."""
        key = (plp.fec_frame, plp.rate, batch)
        if key not in self._decoders:
            if batch % 128 == 0:
                if self.adaptive:
                    # early-exit layered decode, reversed layer order
                    self._decoders[key] = (
                        "nb_adaptive", qldpc.make_adaptive_decoder_nb_fused(
                            plp.fec_frame, plp.rate,
                            max_iters=self.ldpc_max_iters,
                            check_every=2, batch=batch,
                            layer_order="reversed"))
                else:
                    self._decoders[key] = ("nb", qldpc.make_decoder_nb(
                        plp.fec_frame, plp.rate,
                        iters=max(10, self.ldpc_max_iters // 2),
                        batch=batch))
            else:
                self._decoders[key] = ("flood", fldpc.make_decoder(
                    plp.fec_frame, plp.rate, iters=self.ldpc_max_iters))
        return self._decoders[key]

    def _decode_bits(self, plp: PLPParams, llrs_t: torch.Tensor,
                     pstat) -> np.ndarray:
        """(N, nb) LLRs on the device -> (nb, N) hard bits on the host: one
        read-back per decode."""
        kind, dec = self._get_decoder(plp, llrs_t.shape[1])
        if kind == "nb_adaptive":
            bits_t, iters = dec(llrs_t)
            pstat.ldpc_iters.append(int(iters))
            return bits_t.cpu().numpy().T
        if kind == "nb":
            return dec(llrs_t).cpu().numpy().T
        return dec(llrs_t.T).cpu().numpy()

    def _push_plp(self, plp, dyn, plps, bits, pstat, assembler) -> None:
        """BCH, descramble and byte pack on the host, then the TS.  An
        attached `regen_sink` sees the descrambled BB frames, and the frame
        is marked bad when BCH fails on one, as `T2Receiver` does."""
        fails0 = pstat.bch_failures
        bb = fec_device.bch_correct_batch(plp, bits[:, :plp.fec.n_bch],
                                          pstat)
        bb = bbframe.scramble(bb)
        if self.regen_sink is not None:
            self.regen_sink.add_bb(dyn.id, bb)
            if pstat.bch_failures > fails0:
                self.regen_sink.mark_bad()
        frames_bytes = np.packbits(bb, axis=1)
        # per-PLP framing state: each PLP is its own TS byte stream
        assembler.stream(dyn.id if len(plps) > 1 else None
                         ).push_frames(frames_bytes)
        self._track_inband(plp, frames_bytes, pstat, dyn)

    def _get_mf_path(self, params, specs, n_frames, l1_cells):
        """specs: tuple of (plp, num_blocks, start_cell, sub_slices,
        slice_interval): all PLPs decoded by one superstep."""
        key = (params, specs, n_frames, l1_cells)
        if key not in self._mf_paths:
            self._mf_paths[key] = fusedpath.MultiFramePath(
                params, n_frames=n_frames, llr_dtype=torch.bfloat16,
                emit_l1=True, emit_evm=True, l1_cells=l1_cells,
                plp_specs=list(specs))
        return self._mf_paths[key]

    def _track_inband(self, plp, frames_bytes, pstat, dyn) -> None:
        """In-band type-A (clause 5.2.3): parse the payload from the
        Interleaving Frame's first BB frame and cross-check the PREVIOUS
        frame's signalled scheduling against the decoded L1 dynamic."""
        if not plp.in_band_a:
            return
        if not len(frames_bytes):
            # no payload recovered this frame: a later frame must not be
            # checked against an older frame's next-frame schedule
            self._inband_prev[dyn.id] = None
            return
        ib_prev = self._inband_prev.get(dyn.id)
        if ib_prev is not None and (
                ib_prev.current_plp_start != dyn.start
                or ib_prev.current_plp_num_blocks != dyn.num_blocks):
            pstat.inband_mismatches += 1
        ib = inband.extract_from_bb_bytes(frames_bytes[0])
        self._inband_prev[dyn.id] = ib
        if ib is not None:
            pstat.inband.append(ib)

    def decode_frames_batch(self, x, frame_starts, params, plps, l1pre,
                            assembler, stats) -> int:
        """Decode len(frame_starts) frames in ONE MultiFramePath superstep,
        assuming the last seen L1 dynamic for all active PLPs; each frame's
        own L1 is parsed from the superstep's L1 cells, and a frame whose
        dynamic differs is re-decoded through the per-frame path.  The LLR
        scale comes from the previous superstep's EVM.  Returns frames
        decoded."""
        n = len(frame_starts)
        l1post = self._last_l1post
        self.last_batch_failures = 0
        if (l1post is None or self._nvar is None
                or len(l1post.dyn.plp) != len(plps)):
            return 0   # steady state not established: per-frame path
        active = []    # (plp, dyn, sub_slices, slice_interval)
        for plp, dyn in zip(plps, l1post.dyn.plp):
            if (self.plp_filter is not None and dyn.id != self.plp_filter) \
                    or dyn.num_blocks == 0:
                continue
            ss, iv = self._slicing(plp, l1post)
            active.append((plp, dyn, ss, iv))
        if not active:
            return 0
        l1_size = l1mod.L1_PRE_CELLS + l1pre.l1_post_size
        specs = tuple((plp, dyn.num_blocks, dyn.start, ss, iv)
                      for plp, dyn, ss, iv in active)
        mf = self._get_mf_path(params, specs, n, l1_size)
        blen = params.len_frame * params.symbol_size
        bodies = np.empty((n, blen, 2), np.float32)
        for i, fs in enumerate(frame_starts):
            b = x[fs + rxp1.P1_LEN:fs + rxp1.P1_LEN + blen]
            bodies[i, :, 0] = np.real(b)
            bodies[i, :, 1] = np.imag(b)
        inv = torch.tensor(1.0 / max(self._nvar, 1e-4), dtype=torch.float32)
        llrs, l1c, evm = mf(torch.from_numpy(bodies).to(self.device), inv)
        l1c = l1c.float().cpu().numpy()     # bf16 cells, widened exactly
        evm = evm.cpu().numpy()
        self._nvar = float(np.mean(evm))
        # (F, N, nb) per PLP so per-frame slices are leading-axis reads
        lfs = [ll.permute(2, 0, 1) for ll in llrs]

        def dyn_matches(l1p_i):
            if len(l1p_i.dyn.plp) != len(l1post.dyn.plp):
                return False
            if l1p_i.dyn.sub_slice_interval != l1post.dyn.sub_slice_interval:
                return False
            return all(di.id == dj.id and di.start == dj.start
                       and di.num_blocks == dj.num_blocks
                       for di, dj in zip(l1p_i.dyn.plp, l1post.dyn.plp))

        for i in range(n):
            head = l1c[l1mod.L1_PRE_CELLS:l1_size, i, 0] \
                + 1j * l1c[l1mod.L1_PRE_CELLS:l1_size, i, 1]
            stats.last_cells = head[:1024]
            stats.last_cells_label = "L1-post cells (eq, device)"
            l1p_i = l1mod.l1post_decode_hard(head, l1pre)
            if l1p_i is None or not dyn_matches(l1p_i):
                # scheduling changed (or L1 corrupt): exact per-frame path
                ok = self._decode_frame(x, frame_starts[i], params, plps,
                                        l1pre, None, assembler, stats)
                if not ok:
                    self.last_batch_failures += 1
                continue
            self._last_l1post = l1p_i
            if self.regen_sink is not None:
                self.regen_sink.start_frame(params, l1pre, l1p_i)
            for (plp, dyn, _, _), lf in zip(active, lfs):
                pstat = stats.plp_stats.setdefault(
                    dyn.id, rxdecode.PLPDecodeStats())
                bits = self._decode_bits(plp, lf[i], pstat)
                self._push_plp(plp, dyn, plps, bits, pstat, assembler)
            for plp, dyn in zip(plps, l1post.dyn.plp):
                # PLPs skipped this frame (filtered / zero blocks): clear
                # their in-band entries
                if plp.in_band_a and not any(
                        d is dyn for _, d, _, _ in active):
                    self._inband_prev[dyn.id] = None
            stats.snr_db.append(float(-10.0 * np.log10(
                max(float(evm[i]), 1e-12))))
            stats.timing_offset.append(0.0)
            stats.frames_decoded += 1
        self.batch_supersteps += 1
        return n

    def _decode_frame(self, x, frame_start, params, plps, l1pre,
                      l1post_cached, assembler, stats) -> bool:
        body = x[frame_start + rxp1.P1_LEN:
                 frame_start + rxp1.P1_LEN
                 + params.len_frame * params.symbol_size]
        demod = fusedpath.get_fused_demod(params)
        body2 = np.stack([np.real(body), np.imag(body)], -1
                         ).astype(np.float32)
        flat2 = demod(torch.from_numpy(body2).to(self.device))

        # L1 parse on host from the class-layout cells
        l1_size = l1mod.L1_PRE_CELLS + l1pre.l1_post_size
        rows = torch.from_numpy(demod.layout[:l1_size]).to(self.device)
        head2 = flat2[rows].cpu().numpy()
        head = head2[:, 0] + 1j * head2[:, 1]
        stats.last_cells = head[l1mod.L1_PRE_CELLS:l1_size][:1024]
        stats.last_cells_label = "L1-post cells (eq, device)"
        # per-frame timing from the frame's own P1 (feeds the SCO retiming
        # in receive()'s frame loop)
        m = rxp1.measure_p1(np.asarray(x), frame_start, fs=self.fs)
        stats.timing_offset.append(float(m.offset) if m is not None else 0.0)
        snr_seen = None
        if l1post_cached is not None:
            l1post = l1post_cached
        else:
            l1post = l1mod.l1post_decode_hard(
                head[l1mod.L1_PRE_CELLS:l1_size], l1pre)
            if l1post is None:
                # soft fallback using the L1 LDPC parity; nvar from the L1
                # cells' own EVM
                nvar_l1 = rxdecode.estimate_noise_var_l1(
                    head[l1mod.L1_PRE_CELLS:l1_size], l1pre)
                l1post = l1mod.l1post_decode_soft(
                    head[l1mod.L1_PRE_CELLS:l1_size], l1pre, nvar=nvar_l1)
            if l1post is None:
                stats.l1_failures += 1
                l1post = self._last_l1post
                if l1post is None:
                    stats.snr_db.append(0.0)
                    return False
                if l1post.dyn_next is not None:
                    l1post = dataclasses.replace(l1post, dyn=l1post.dyn_next)
                else:
                    # in-band type-A scheduling fallback (clause 5.2.3)
                    l1post = self._inband_patched(l1post)
            else:
                self._last_l1post = l1post
        if self.regen_sink is not None:
            self.regen_sink.start_frame(params, l1pre, l1post)

        for plp, dyn in zip(plps, l1post.dyn.plp):
            if (self.plp_filter is not None and dyn.id != self.plp_filter) \
                    or dyn.num_blocks == 0:
                # skipped this frame: clear its stale in-band entry
                if plp.in_band_a:
                    self._inband_prev[dyn.id] = None
                continue
            pstat = stats.plp_stats.setdefault(
                dyn.id, rxdecode.PLPDecodeStats())
            ss, iv = self._slicing(plp, l1post)
            path = self._get_path(params, plp, dyn.num_blocks,
                                  l1_size, dyn.start, ss, iv)
            # noise estimate from the L1-pre cells' EVM (BPSK, unrotated)
            nvar = rxdecode.estimate_noise_var_l1(
                head[:l1mod.L1_PRE_CELLS], l1pre_bpsk=True)
            self._nvar = nvar      # seeds the batched superstep's LLR scale
            if snr_seen is None:
                # unit constellation power: the EVM noise estimate is the
                # inverse SNR
                snr_seen = -10.0 * np.log10(max(nvar, 1e-12))
            llrs_t = path(flat2, torch.tensor(1.0 / max(nvar, 1e-4),
                                              dtype=torch.float32))
            bits = self._decode_bits(plp, llrs_t, pstat)
            self._push_plp(plp, dyn, plps, bits, pstat, assembler)
        stats.snr_db.append(float(snr_seen) if snr_seen is not None
                            else 30.0)
        stats.frames_decoded += 1
        return True
