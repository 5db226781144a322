"""The port's receive superstep (sdr_receiver_dvb_t2_tpu_torch/rx/
superstep.py) end to end against the JAX package's pieces composed as the
repository's bench composes them (`one_superstep`): raw impaired samples
-> front end -> fused path -> layered LDPC (K1 in interpret mode) -> BCH
gate -> BB bytes, at the 8K/16QAM SHORT mode.  Decoded BB bytes, hashes
and sweep counts must be equal, and the TS reassembled from every frame
must be the transmitted TS.  Also: the port imports and runs with jax
and the JAX package blocked."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.ops import fec_device as jfec
from sdr_receiver_dvb_t2_tpu.ops import frontend_device as jfe
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qldpc
from sdr_receiver_dvb_t2_tpu.rx import fusedpath as jfp
from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as tss
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as R

torch.set_num_threads(1)

F, NB, HALF = 2, 3, 8
FS = benchgen.FS
CFO, SCO, PHASE0 = benchgen.CFO_HZ, benchgen.SCO, benchgen.PHASE0


def _mode():
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=NB,
                    time_il_length=1)
    return p, plp


def _capture():
    p, plp = _mode()
    ts, frames, rows = benchgen.modulate(R(p), R(plp), F, seed=5)
    pad = 2 * HALF
    ratio = np.float32(1 + SCO)
    n_raw = int(np.ceil((p.frame_samples + pad) * ratio)) + 4 * HALF
    clean = np.pad(np.stack([frames.real, frames.imag], -1),
                   ((0, 0), (pad, 0), (0, 0))).astype(np.float32)
    rms = float(np.sqrt((clean ** 2).sum(-1).mean()))
    raw = jfe.make_impairer(n_raw, FS, half=HALF)(
        jnp.asarray(clean), jnp.float32(CFO), jnp.float32(ratio),
        jnp.float32(PHASE0), jnp.asarray([0.02 * rms, -0.015 * rms],
                                         jnp.float32),
        jnp.asarray([1.02, 0.012], jnp.float32), jax.random.PRNGKey(1),
        jnp.float32(0.0))
    track = np.array([CFO, ratio, HALF * ratio, PHASE0], np.float32)
    return p, plp, ts, rows, np.asarray(raw), track


def _jax_superstep(p, plp, raw, inv_nvar, track, weights):
    mf = jfp.MultiFramePath(p, plp, NB, F, llr_dtype=jnp.bfloat16)
    fe = jfe.make_frontend_symbols(p.len_frame, p.symbol_size, p.guard_size,
                                   FS, half=HALF, sym_order=mf.demod.sym_order,
                                   out_dtype=jnp.bfloat16)
    (sr, si), _, _ = fe(jnp.asarray(raw[..., 0]), jnp.asarray(raw[..., 1]),
                        *(jnp.float32(v) for v in track))
    llrs = mf._fn_syms(sr, si, jnp.float32(inv_nvar))
    dec = qldpc.make_adaptive_decoder_nb_fused_io(
        plp.fec_frame, plp.rate, max_iters=24, check_every=1, batch=NB,
        interpret=True, layer_order="reversed")
    bch = jfec.make_bch_check_nb(plp.fec_frame, plp.rate)
    pack = jfec.make_bb_bytes_nb(plp.fec_frame, plp.rate)
    min_it = 0 if inv_nvar >= 316.0 else 8
    sums, oks, byts, iters = [], [], [], 0
    for f in range(F):
        bits, it = dec(llrs[:, :, f], min_it)
        b = pack(bits)
        sums.append(np.asarray(jnp.sum(b[None] * jnp.asarray(weights),
                                       dtype=jnp.int32, axis=(1, 2))))
        oks.append(int(jnp.sum(bch(bits[:plp.fec.n_bch]))))
        byts.append(np.asarray(b))
        iters += int(it)
    return np.stack(sums), np.array(oks), iters, np.stack(byts)


def test_superstep_equals_jax_and_transmitted_ts():
    p, plp, ts, rows, raw, track = _capture()
    kb8 = plp.fec.k_bch // 8
    weights = tss.hash_weights(kb8, NB)
    step = tss.Superstep(R(p), R(plp), NB, F, FS, weights)
    inv = 100.0                                     # 20 dB: floor at 8
    marks = []
    sums, oks, iters, byts = step(torch.from_numpy(raw[..., 0].copy()),
                                  torch.from_numpy(raw[..., 1].copy()), inv,
                                  torch.from_numpy(track), keep=(0, 1),
                                  mark=marks.append)
    # the stage marks a profiler hangs its events on
    assert marks == ["frontend", "demod_llr"] + ["ldpc", "fec_tail"] * F
    r_sums, r_oks, r_iters, r_byts = _jax_superstep(p, plp, raw, inv, track,
                                                    weights)
    np.testing.assert_array_equal(byts.numpy(), r_byts)
    np.testing.assert_array_equal(sums.numpy(), r_sums)
    np.testing.assert_array_equal(oks.numpy(), r_oks)
    assert int(iters) == r_iters == 8 * F
    np.testing.assert_array_equal(oks.numpy(), [NB] * F)
    expect = np.stack([tss.expected_hash(rows[f], weights)
                       for f in range(F)])
    np.testing.assert_array_equal(sums.numpy(), expect)
    got = benchgen.reassemble_ts(byts.numpy())
    assert len(got) > len(ts) // 2
    np.testing.assert_array_equal(got, ts[:len(got)])


def test_tracking_estimate_on_port_impaired_capture():
    """benchgen's acquisition flow at the small mode: the port's impairer
    (with AWGN from a torch.Generator) and the product's acquisition
    recover the bench's CFO, SCO and frame start."""
    p, plp = _mode()
    _, frames, _ = benchgen.modulate(R(p), R(plp), 2, seed=6)
    gen = torch.Generator().manual_seed(3)
    track, (cfo, ratio, pos0) = benchgen.estimate_tracking(
        frames, 10 ** -2.5, gen, "cpu")
    assert abs(cfo - benchgen.CFO_HZ) < 5.0
    assert abs(ratio - 1 - benchgen.SCO) < 1e-6
    assert abs(pos0 - HALF * (1 + benchgen.SCO)) < 1.0
    np.testing.assert_allclose(track.numpy(), [cfo, ratio, pos0, 0.0],
                               rtol=1e-6)


def test_hash_catches_slot_and_frame_permutations():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (2, NB, 40)).astype(np.uint8)
    w = tss.hash_weights(40, NB)
    h0, h1 = (tss.expected_hash(r, w) for r in rows)
    assert not np.array_equal(h0, h1)
    assert not np.array_equal(tss.expected_hash(rows[0][::-1], w), h0)


GUARD = """
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "sdr_receiver_dvb_t2_tpu", "triton")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this test: " + name)
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import torch
import sdr_receiver_dvb_t2_tpu_torch as m
torch.set_num_threads(1)
# Python modules only: the native library, once built, is a .so that
# pkgutil lists beside them
names = [mod.name for mod in pkgutil.walk_packages(m.__path__,
                                                   m.__name__ + ".")
         if mod.ispkg or mod.module_finder.find_spec(mod.name).origin
         .endswith(".py")]
for name in names:
    importlib.import_module(name)

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import DeviceT2Receiver
from sdr_receiver_dvb_t2_tpu_torch.tx.modulator import T2Modulator
p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
             pilot_pattern=PilotPattern.PP1, extended_carrier=False, n_data=9)
plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                fec_frame=FECFrame.SHORT, num_blocks_max=3, time_il_length=1)
mod = T2Modulator(p, [plp])
rng = np.random.default_rng(2)
ts = rng.integers(0, 256, (mod.packets_needed(2) + 4, 188)).astype(np.uint8)
ts[:, 0] = 0x47
ts[:, 1] &= 0x7F
res = DeviceT2Receiver(device="cpu").receive(
    mod.modulate(ts.reshape(-1), 2).samples)
exact = len(res.ts) > 0 and np.array_equal(res.ts,
                                           ts.reshape(-1)[:len(res.ts)])
bad = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
print(len(names), res.stats.frames_decoded, bool(exact), bad)
"""


def test_port_imports_without_jax():
    """In a process where importing jax, jaxlib, triton or the JAX package
    raises: every module of the port imports, and a modulate ->
    DeviceT2Receiver(device="cpu").receive() loopback gives the
    transmitted TS."""
    out = subprocess.run([sys.executable, "-c", GUARD], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    n_mods, frames, exact, bad = out.stdout.strip().split(" ", 3)
    assert int(n_mods) >= 65              # every module was imported
    assert int(frames) == 2 and exact == "True"
    assert bad == "[]"
