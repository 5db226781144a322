"""The live path's input: one contiguous capture of a cell's mode at an
SDR's own sample rate, interleaved int16 I/Q, that loops with no seam.

- `Payload`: a transport stream that repeats every P BB frames, P = 188 /
  gcd(data field bytes, 188), the fewest BB frames that hold whole
  packets; its CRC-8 chain closes over the period, so the looped stream
  is one valid TS.
- `render`: C frames of the batch cells' generator (`synth.BaseFrame`'s
  L1, carrier map and P1; `synth.make_slot_synth`) back to back, frame
  c's slot b carrying the period's BB frame (c * nb + b) mod P, so every
  frame carries other bytes and frame c + 1 goes on where frame c ended.
  C * nb is a multiple of P, so the last frame runs on into the first.
  The frames are resampled to device_rate * (1 + SCO) and take the batch
  cells' CFO, IQ imbalance, DC, AWGN and int16 ADC grid (`synth`'s
  constants), all on the device; the capture comes to the host.  Its
  length in raw samples is rounded to a whole number and its CFO to whole
  cycles over the loop, so the capture is one period of a periodic signal
  (the noise aside): the seam, on frame 0's P1, is exact.

It imports nothing of the program."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import synth
from .dvbt2 import bbframe

ELEMENTARY = 64e6 / 7          # the 8 MHz channel's elementary rate
SEGMENT = 1 << 20              # raw samples rendered at a time


class Payload:
    """The looped TS of a PLP, from a seed.  packets (K, 188) uint8, sync
    bytes 0x47 and no transport-error bits; rows (P, k_bch // 8) uint8,
    codewords and cells (P, cpf): the period's BB frames as `synth.encode`
    returns them; dfl: data-field bytes of a BB frame."""

    def __init__(self, plp, seed: int):
        kbch = plp.fec.k_bch
        self.dfl = (kbch - bbframe.BB_HEADER_BITS) // 8
        self.period = bbframe.TS_PACKET // math.gcd(self.dfl,
                                                    bbframe.TS_PACKET)
        n_pkt = self.period * self.dfl // bbframe.TS_PACKET
        rng = np.random.default_rng(seed)
        ts = rng.integers(0, 256, (n_pkt, bbframe.TS_PACKET), dtype=np.uint8)
        ts[:, 0] = bbframe.TS_SYNC
        ts[:, 1] &= 0x7F
        self.packets = ts
        # two periods through the mode adapter: the second's first packet
        # carries the CRC-8 of the first's last, as the loop does
        adapter = bbframe.ModeAdapter(kbch=kbch, isi=plp.plp_id)
        adapter.push_packets(np.concatenate([ts, ts]))
        bb = np.stack([adapter.next_frame()
                       for _ in range(2 * self.period)])[self.period:]
        self.rows, self.codewords, self.cells = synth.encode(plp, bb)

    def loop_frames(self, nb: int) -> int:
        """Frames of nb blocks in the shortest whole loop of the TS."""
        return self.period // math.gcd(nb, self.period)


def chunk_for(step: float) -> int:
    """The most resampler outputs, a power of two, that may share one
    stencil start at read step `step`: their drift, folded into mu, keeps
    mu inside the Farrow bank's fitted [0, 2)."""
    chunk = 1
    while 2 * chunk * abs(step - 1.0) < 0.9 and chunk < 16384:
        chunk *= 2
    return chunk


def _resample_loop(x: torch.Tensor, k0: int, n: int, step: float):
    """Outputs k0 .. k0 + n of a periodic signal x ((N, 2) f32, one
    period) read at positions k * step, by the generator's Farrow bank in
    chunks of outputs that share a stencil start (`chunk_for`).  Chunk
    anchors are float64, so the positions stay exact over the whole loop."""
    cf = synth.farrow_bank()
    dev, n_in = x.device, x.shape[0]
    chunk = chunk_for(step)
    half, slice_len = synth.HALF, chunk + 2 * synth.HALF + 2
    delta = step - 1.0
    c = torch.arange(k0 // chunk, -(-(k0 + n) // chunk), dtype=torch.float64,
                     device=dev)
    r0 = c * chunk * delta
    b = torch.floor(torch.minimum(r0, r0 + (chunk - 1) * delta))
    k_local = torch.arange(chunk, dtype=torch.float32, device=dev)
    mu = (r0 - b).float()[:, None] + k_local * float(delta)
    s = (c * chunk).long() + b.long() - (half - 1)
    sl = x[torch.remainder(s[:, None] + torch.arange(slice_len, device=dev),
                           n_in)]
    acc = None
    for t, cf_t in enumerate(cf):
        term = sl[:, t:t + chunk] * synth._horner(cf_t, mu)[..., None]
        acc = term if acc is None else acc + term
    lo = k0 - int(c[0]) * chunk
    return acc.reshape(-1, 2)[lo:lo + n]


def render(base, payload: Payload, n_frames: int, device_rate: float,
           nvar_rel: float, generator, device):
    """The capture: (N_raw, 2) int16 on the host, and its truth {"n_el":
    elementary samples of the loop, "n_raw", "cfo_hz", "ratio": raw
    samples per elementary sample, "frame_raw": raw samples per frame}."""
    p, nb = base.p, base.nb
    synth_one = synth.make_slot_synth(base, payload.cells, device)
    n_len = p.frame_samples
    clean = torch.empty((n_frames * n_len, 2), dtype=torch.float32,
                        device=device)
    for f in range(n_frames):
        fr = synth_one((f * nb + np.arange(nb)) % payload.period)
        clean[f * n_len:(f + 1) * n_len] = torch.view_as_real(fr)
    n_el = clean.shape[0]
    n_raw = int(round(n_el * device_rate * (1.0 + synth.SCO) / ELEMENTARY))
    cycles = int(round(synth.CFO_HZ * n_el / ELEMENTARY))
    step = n_el / n_raw
    pwr = (clean ** 2).sum(-1).mean()
    rms = torch.sqrt(pwr)
    adc = 32000.0 / clean.abs().max()
    dc = torch.stack([synth.DC_RE * rms, synth.DC_IM * rms])
    g = torch.tensor(synth.IQ_G, device=device)
    c = torch.tensor(synth.IQ_C, device=device)
    sigma = torch.sqrt(nvar_rel * pwr / 2.0)
    out = np.empty((n_raw, 2), np.int16)
    for k0 in range(0, n_raw, SEGMENT):
        n = min(SEGMENT, n_raw - k0)
        y = _resample_loop(clean, k0, n, step)
        m = torch.arange(k0, k0 + n, dtype=torch.int64, device=device)
        ph = (synth.PHASE0 + 2.0 * math.pi * torch.remainder(
            m * cycles, n_raw).double() / n_raw).float()
        cs, sn = torch.cos(ph), torch.sin(ph)
        i, q = y[:, 0], y[:, 1]
        i, q = i * cs - q * sn, q * cs + i * sn
        q = (q * torch.sqrt(1.0 - c * c) + c * i) / g
        y = torch.stack([i, q], -1) + dc
        if nvar_rel > 0:
            y = y + torch.randn(y.shape, generator=generator,
                                device=device) * sigma
        out[k0:k0 + n] = torch.round(torch.clamp(
            y * adc, -32767.0, 32767.0)).to(torch.int16).cpu().numpy()
    truth = {"n_el": n_el, "n_raw": n_raw,
             "cfo_hz": cycles * ELEMENTARY / n_el,
             "ratio": n_raw / n_el, "frame_raw": n_len * n_raw / n_el}
    return out, truth
