"""End-to-end DVB-T2 modulator: TS bytes -> baseband IQ sample stream.

This is the framework's signal source (SURVEY.md §7 step 3): the reference
project never needed one because it had an antenna; we need it for golden
e2e tests, capture synthesis at controlled SNR/CFO/SCO, and as a transmit
capability in its own right.

Usage:
    mod = T2Modulator(T2Params(), [PLPParams()])
    iq = mod.modulate(ts_bytes, n_frames=2)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..dvbt2 import bbframe, inband, l1 as l1mod
from ..dvbt2.params import PLPParams, T2Params
from . import fec as txfec
from . import frame as txframe
from . import ofdm as txofdm


@dataclass
class ModulatorOutput:
    samples: np.ndarray          # complex64 IQ at 9.142857 Msps (TX group 1)
    l1pre: l1mod.L1Pre
    l1post_frames: list          # per-frame L1Post (dynamic differs)
    n_frames: int
    samples2: np.ndarray | None = None   # MISO TX group 2 stream
    frames: list | None = None   # per-T2-frame sample arrays (no FEF parts);
    # lets a multiplexer interleave its own FEF content (tx/mux.py)


class T2Modulator:
    def __init__(self, p: T2Params, plps: list[PLPParams],
                 l1_post_mod: int = 1, hem: bool = False,
                 l1_repetition: bool = False, fef_insert: bool = True,
                 bb_tap=None, bb_injector=None):
        self.p = p
        self.plps = plps
        self.l1_post_mod = l1_post_mod
        self.hem = hem
        self.l1_repetition = l1_repetition
        # fef_insert=False emits the FEF *signalling* but no placeholder
        # FEF samples — a multiplexer (tx/mux.py) supplies the FEF content
        # (e.g. a T2-Lite signal) between the returned per-frame arrays
        self.fef_insert = fef_insert
        # T2-MI gateway/modulator split (tx/t2mi.py): `bb_tap(fidx, plp_id,
        # bb_stack)` observes every mode-adapted BB-frame stack (the T2-MI
        # gateway serializes them); `bb_injector(fidx, plp_id, nb) ->
        # (nb, kbch) bits` replaces mode adaptation entirely (a T2-MI
        # modulator plays received BB frames instead of segmenting TS)
        self.bb_tap = bb_tap
        self.bb_injector = bb_injector
        # `l1_injector(fidx) -> (L1Pre, L1Post)` replaces build_l1/dynamic
        # generation: a T2-MI modulator transmits the gateway's signalling
        # verbatim; the physical slice layout is still computed locally and
        # checked against the signalled dynamic (tx/t2mi.py)
        self.l1_injector = None
        self.adapters = [bbframe.ModeAdapter(kbch=c.fec.k_bch, hem=hem,
                                             isi=c.plp_id)
                         for c in plps]

    def blocks_per_frame(self, plp: PLPParams) -> int:
        """FEC blocks each PLP contributes per frame (fills num_blocks_max)."""
        return plp.num_blocks_max

    def frame_budget_check(self) -> None:
        need = sum(self.blocks_per_frame(c) * c.cells_per_fec_block
                   for c in self.plps)
        pre, _ = l1mod.build_l1(self.p, self.plps)
        avail = self.p.cells_per_frame - l1mod.L1_PRE_CELLS - pre.l1_post_size
        if need > avail:
            raise ValueError(f"PLP cells {need} exceed frame capacity {avail}")

    def packets_needed(self, n_frames: int) -> int:
        return sum(a.packets_needed(n_frames * self.blocks_per_frame(c))
                   for a, c in zip(self.adapters, self.plps))

    def modulate(self, ts: np.ndarray, n_frames: int) -> ModulatorOutput:
        """ts: flat uint8 TS bytes (same stream feeds all PLPs' adapters in
        plp order -- single-PLP is the common case)."""
        self.frame_budget_check()
        p = self.p
        ts = np.asarray(ts, dtype=np.uint8)
        # distribute TS packets: round-robin by need per adapter
        pos = 0
        frames_samples = []
        t2_frames = []           # group-1 T2 frames only, no FEF parts
        frames_samples2 = []
        if self.l1_injector is not None:
            l1pre, l1post_template = self.l1_injector(0)
        else:
            l1pre, l1post_template = l1mod.build_l1(
                p, self.plps, num_frames=n_frames,
                l1_post_mod=self.l1_post_mod,
                l1_repetition=self.l1_repetition)
        l1posts = []
        # in-band type-A payloads (clause 5.2.3): this modulator's frame
        # scheduling is constant, so the next Interleaving Frame's dynamic
        # equals the current one; pre-compute it from the slice LENGTHS
        # (layout depends only on those) before any frame is encoded.
        inband_bits: dict[int, np.ndarray] = {}
        if any(c.in_band_a for c in self.plps):
            dummy = [np.zeros(self.blocks_per_frame(c) * c.cells_per_fec_block,
                              np.complex64) for c in self.plps]
            _, starts0, ss0, t20 = txframe.layout_plp_slices(self.plps, dummy)
            dyn0 = l1mod.L1PostDynamic(
                plp=[l1mod.L1PostDynPLP(id=c.plp_id, start=starts0[c.plp_id],
                                        num_blocks=self.blocks_per_frame(c))
                     for c in self.plps])
            for c in self.plps:
                if c.in_band_a:
                    inband_bits[c.plp_id] = inband.build_inband_a(
                        c.plp_id, dyn0, sub_slice_interval=ss0,
                        type_2_start=t20).pack()
        for fidx in range(n_frames):
            plp_slices = []
            for a, cfg in zip(self.adapters, self.plps):
                nb = self.blocks_per_frame(cfg)
                if self.bb_injector is not None:
                    # T2-MI playout: BB frames arrive fully mode-adapted
                    # (BBHEADER + data field + any in-band padding) from the
                    # gateway; no TS segmentation happens in the modulator
                    bb = np.asarray(self.bb_injector(fidx, cfg.plp_id, nb),
                                    dtype=np.uint8)
                    if bb.shape != (nb, cfg.fec.k_bch):
                        raise ValueError(
                            f"injected BB stack {bb.shape} != "
                            f"({nb}, {cfg.fec.k_bch})")
                else:
                    npkt = a.packets_needed(nb)
                    if npkt:
                        take = npkt * bbframe.TS_PACKET
                        if pos + take > len(ts):
                            raise ValueError("not enough TS input")
                        a.push_packets(ts[pos:pos + take])
                        pos += take
                    ib = inband_bits.get(cfg.plp_id)
                    bb = np.stack(
                        [a.next_frame(padding_bits=ib if j == 0 else None)
                         for j in range(nb)])
                if self.bb_tap is not None:
                    self.bb_tap(fidx, cfg.plp_id, bb)
                cells = txfec.plp_encode(cfg, bb)
                plp_slices.append(txframe.interleave_plp_frame(cfg, cells))
            plp_slices, starts, ss_interval, t2_start = \
                txframe.layout_plp_slices(self.plps, plp_slices)
            dyn_plps = [l1mod.L1PostDynPLP(
                id=cfg.plp_id, start=starts[cfg.plp_id],
                num_blocks=self.blocks_per_frame(cfg))
                for cfg in self.plps]
            def make_dyn(fi):
                return l1mod.L1PostDynamic(
                    frame_idx=fi, plp=dyn_plps,
                    sub_slice_interval=ss_interval, type_2_start=t2_start)

            dyn_next = None
            if self.l1_injector is not None:
                # T2-MI playout: transmit the gateway's signalling verbatim,
                # but verify it against the locally computed physical layout
                # (a schedule mismatch here means a corrupt/incoherent feed)
                l1post = self.l1_injector(fidx)[1]
                for dp in l1post.dyn.plp:
                    if int(dp.start) != int(starts[dp.id]):
                        raise ValueError(
                            f"T2-MI L1 dynamic start {dp.start} for PLP "
                            f"{dp.id} != local layout {starts[dp.id]}")
            else:
                if self.l1_repetition:
                    # constant scheduling: next frame's dynamic differs only
                    # in frame_idx (clause 7.2.3.1 L1 repetition)
                    dyn_next = make_dyn((fidx + 1) % max(n_frames, 1))
                l1post = l1mod.L1Post(
                    num_plp=len(self.plps), plp=l1post_template.plp,
                    sub_slices_per_frame=max(
                        [c.sub_slices for c in self.plps if c.plp_type == 2],
                        default=1),
                    fef=l1post_template.fef,
                    dyn=make_dyn(fidx), dyn_next=dyn_next)
            l1posts.append(l1post)
            l1_cells = np.concatenate([
                l1mod.l1pre_encode(l1pre),
                l1mod.l1post_encode(l1post, self.l1_post_mod,
                                    repetition=self.l1_repetition,
                                    scrambled=bool(l1pre.l1_post_scrambled))])
            frame_cells = txframe.build_frame_cells(p, l1_cells, plp_slices)
            symbols = txframe.cells_to_symbols(p, frame_cells)
            if p.miso:
                pg1 = dataclasses.replace(p, miso_group=0)
                pg2 = dataclasses.replace(p, miso_group=1)
                frames_samples.append(txofdm.frame_to_samples(
                    pg1, txframe.symbols_to_carriers(pg1, symbols)))
                frames_samples2.append(txofdm.frame_to_samples(
                    pg2, txframe.symbols_to_carriers(pg2, symbols)))
            else:
                carriers = txframe.symbols_to_carriers(p, symbols)
                frames_samples.append(txofdm.frame_to_samples(p, carriers))
            t2_frames.append(frames_samples[-1])
            if p.fef_after(fidx) and self.fef_insert:
                # FEF part after this frame (clause 8.3.1); in MISO both
                # transmitter groups emit the same FEF content
                fef = txofdm.generate_fef_part(
                    p, rms=float(np.sqrt(np.mean(
                        np.abs(frames_samples[-1]) ** 2))), seed=fidx)
                frames_samples.append(fef)
                if p.miso:
                    frames_samples2.append(fef)
        return ModulatorOutput(samples=np.concatenate(frames_samples),
                               l1pre=l1pre, l1post_frames=l1posts,
                               n_frames=n_frames,
                               samples2=(np.concatenate(frames_samples2)
                                         if p.miso else None),
                               frames=t2_frames)


def awgn(samples: np.ndarray, snr_db: float, seed: int = 0) -> np.ndarray:
    """Add complex AWGN at the given SNR (signal power measured)."""
    rng = np.random.default_rng(seed)
    power = np.mean(np.abs(samples) ** 2)
    nvar = power / (10.0 ** (snr_db / 10.0))
    noise = (rng.normal(0, np.sqrt(nvar / 2), len(samples))
             + 1j * rng.normal(0, np.sqrt(nvar / 2), len(samples)))
    return (samples + noise).astype(np.complex64)


def apply_cfo(samples: np.ndarray, cfo_hz: float,
              fs: float = 64.0 / 7.0 * 1e6) -> np.ndarray:
    """Apply a carrier-frequency offset."""
    n = np.arange(len(samples))
    return (samples * np.exp(2j * np.pi * cfo_hz * n / fs)).astype(np.complex64)
