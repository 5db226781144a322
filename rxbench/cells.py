"""A cell's inputs and the program under test, found by the cell's name.

`rxbench/workloads/<name>.json` is one cell (its configuration, SNR, echo,
frames per step, pool size, sampled frames and limits);
`rxbench/configs/<config>.json` is one configuration (the broadcast mode);
`BENCHMARK.json` lists the cell with its chips and metrics.  Nothing here
names a cell: a later cell is a new pair of files and entries.

`Inputs` is the generator's side (payload, frames, impaired step inputs,
truth); `Program` is the program's side (the superstep and the tracking
state its acquisition estimates).  The program is
`sdr_receiver_dvb_t2_tpu_torch`; nothing here imports the JAX package.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .gen import synth

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CLEAN_INV_NVAR_DB = 33.0      # the LLR scale of a step without AWGN
ACQ_TRIES = 12                # 2-frame captures the acquisition may take
HOST_SLOTS = 2                # steps whose bytes are compared in full


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def specs(name: str) -> tuple[dict, dict, dict]:
    """-> (the cell's entry in BENCHMARK.json, its workload file, its
    configuration file)."""
    entry = next((w for w in bench_spec()["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(HERE / "workloads" / f"{name}.json")
    if wl["config"] != entry["config"]:
        raise SystemExit(f"workload {name}: config {wl['config']!r} differs "
                         f"from BENCHMARK.json's {entry['config']!r}")
    cfg = load_json(HERE / "configs" / f"{wl['config']}.json")
    return entry, wl, cfg


def streams(seed: int) -> dict:
    """Independent integer seeds of one run, all drawn from --seed."""
    ss = np.random.SeedSequence(int(seed))
    names = ("payload", "pool", "noise", "acq", "weights", "sample")
    return {n: int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for n, s in zip(names, ss.spawn(len(names)))}


def nvar_rel(wl: dict) -> float:
    snr = float(wl["snr_db"])
    return 0.0 if snr <= 0 else 10.0 ** (-snr / 10.0)


def inv_nvar(wl: dict) -> float:
    snr = float(wl["snr_db"])
    return 10.0 ** ((snr if snr > 0 else CLEAN_INV_NVAR_DB) / 10.0)


class Inputs:
    """The generator's side of one run: the base frame from the payload
    seed, `pool` step inputs of F distinct frames each (frame f of entry k
    carries the blocks rolled by f + offsets[k]), impaired on `device`,
    and the truth: each entry's BB bytes per frame and slot, its
    codewords, and the 64-bit hashes under the run's own weights."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, pool=None):
        st = streams(seed)
        self.p, self.plp = synth.mode(cfg)
        blocks = synth.fec_blocks_per_frame(self.p, self.plp)
        if blocks != cfg["fec_blocks_per_frame"] or \
                blocks != self.plp.num_blocks_max:
            raise SystemExit(f"configuration {cfg['name']}: the mode holds "
                             f"{blocks} FEC blocks per frame, the file says "
                             f"{cfg['fec_blocks_per_frame']} and num_blocks "
                             f"{self.plp.num_blocks_max}")
        self.frames = int(wl["frames"])
        self.device = device
        self.base = synth.BaseFrame(self.p, self.plp, st["payload"])
        self.nb = self.base.nb
        self.synth = synth.make_frame_synth(self.base, self.frames, device)
        n_pool = int(wl["pool"]) if pool is None else pool
        rng = np.random.default_rng(st["pool"])
        self.offsets = [int(o) for o in rng.choice(self.nb, n_pool,
                                                   replace=False)]
        self.noise = torch.Generator(device=device).manual_seed(st["noise"])
        self.acq = torch.Generator(device=device).manual_seed(st["acq"])
        self.nvar_rel = nvar_rel(wl)
        self.inv_nvar = inv_nvar(wl)
        echo = (float(wl["echo"][0]), int(wl["echo"][1]))
        self.pool = [synth.impaired(self.synth(o), self.nvar_rel, self.noise,
                                    device, echo=echo) for o in self.offsets]
        kb8 = self.plp.fec.k_bch // 8
        self.weights = np.random.default_rng(st["weights"]).integers(
            -2**31, 2**31, (2, kb8, self.nb), dtype=np.int64).astype(np.int32)
        self.slots = [self.base.slots(self.frames, o) for o in self.offsets]
        self.hashes = [self.expected_hashes(s) for s in self.slots]
        self.sample_rng = np.random.default_rng(st["sample"])

    def expected_hashes(self, slots: np.ndarray) -> np.ndarray:
        """(F, 2) int32: frame f's wrapping int32 sum of its bytes (slot b
        holding rows[slots[f, b]]) times the weights."""
        w = self.weights.astype(np.int64)              # (2, kb8, B)
        out = np.empty((len(slots), 2), np.int64)
        for f, s in enumerate(slots):
            r = self.base.rows[s].astype(np.int64).T   # (kb8, B)
            out[f] = (r[None] * w).sum(axis=(1, 2))
        return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)

    def truth_bytes(self, entry: int) -> np.ndarray:
        """(F, kb8, B) uint8: every frame's BB bytes, slot b in column b."""
        return np.ascontiguousarray(
            self.base.rows[self.slots[entry]].transpose(0, 2, 1))


class Program:
    """The program's side: `sdr_receiver_dvb_t2_tpu_torch`'s superstep
    for the cell's mode at F frames per step, and the tracking state its
    acquisition (`utils/benchgen.estimate_tracking`: the product's
    `T2Receiver.refine_acquire` on a contiguous 2-frame capture) estimates
    from the generator's frames 0 and 1, and where it fails to lock, from
    frames 2 and 3, and so on (ACQ_TRIES pairs).  The capture carries the
    cell's impairments but no AWGN: the acquisition fails to lock on about
    half of the noise draws at 19 dB and on some payloads without noise
    (`PERF.md`, Open questions), and set-up has to lock on every seed.

    The step's bytes come to the host into buffers allocated and touched
    once (`fetch`): slot 0 for every step, and one slot of its own for
    each step whose bytes are compared in full."""

    def __init__(self, inputs: Inputs):
        from sdr_receiver_dvb_t2_tpu_torch.rx.superstep import Superstep
        from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
        from sdr_receiver_dvb_t2_tpu_torch.utils.reference import \
            params_from_reference
        dev = inputs.device
        t0 = time.perf_counter()
        self.p = params_from_reference(inputs.p)
        self.plp = params_from_reference(inputs.plp)
        self.step = Superstep(self.p, self.plp, inputs.nb, inputs.frames,
                              synth.FS, inputs.weights)
        t1 = time.perf_counter()
        # a receiver that fails to lock looks again at the next frames
        frames = inputs.synth(inputs.offsets[0])
        tries = max(1, min(ACQ_TRIES, inputs.frames // 2))
        for k in range(tries):
            try:
                self.track, est = benchgen.estimate_tracking(
                    frames[2 * k:2 * k + 2], 0.0, inputs.acq, dev)
                break
            except RuntimeError:
                if k + 1 == tries:
                    raise
        self.acq_tries = k + 1
        del frames
        self.track_host = [float(v) for v in self.track.cpu()]
        self.seconds = {"superstep": t1 - t0,
                        "acquisition": time.perf_counter() - t1}
        self.track_err = {"cfo_hz": est[0] - synth.TRUTH[0],
                          "sco_ppm": (est[1] - synth.TRUTH[1]) * 1e6,
                          "pos0": est[2] - synth.TRUTH[2]}
        self.inv = torch.tensor(inputs.inv_nvar, dtype=torch.float32,
                                device=dev)
        self.keep = tuple(range(inputs.frames))
        self.host = None

    def issue(self, raw, mark=None):
        """One step of the superstep on one pool entry, every frame kept
        (device tensors, nothing waited for)."""
        return self.step(raw[0], raw[1], self.inv, self.track,
                         keep=self.keep, mark=mark)

    def fetch(self, out, slot: int = 0):
        """A step's results on the host: the bytes first, into host buffer
        `slot`, then the small rest.  -> (hashes (F, 2), BCH-clean counts
        (F,), sweeps, bytes (F, kb8, B)) as numpy."""
        sums, oks, iters, kept = out
        if self.host is None:
            self.host = [torch.zeros(kept.shape, dtype=kept.dtype)
                         for _ in range(1 + HOST_SLOTS)]
        self.host[slot].copy_(kept)
        return (sums.cpu().numpy(), oks.cpu().numpy(), int(iters),
                self.host[slot].numpy())

    def __call__(self, raw, mark=None):
        return self.fetch(self.issue(raw, mark))
