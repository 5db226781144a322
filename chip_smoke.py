#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It builds the port's CUDA kernels from `sdr_receiver_dvb_t2_tpu_torch/csrc`
and drives the port's main paths at the headline mode: 32K FFT, GI 1/128,
PP7 extended carriers, 59 data symbols, 256QAM C2/3 NORMAL FEC, B=128
codewords per frame.

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card's name and power limit; build the kernels (one nvcc per
     source, started together).
  2. each layered LDPC kernel against its plain PyTorch version on
     synthetic codewords, tolerance 0 on bits and sweep counts, both timed
     with CUDA events:
       K1 (bf16 LLRs, adaptive, check every sweep) and K2 (f32 LLRs,
       adaptive, check every 2 sweeps), NORMAL C2/3, B=128, reversed
       layers, 24 sweeps max: clean, sigma 0.65, sigma 0.74, and sigma
       0.65 with a floor of 8;
       K3 (fixed, bf16 c2v) at NORMAL C2/3 and K4 (fixed, f32 c2v) at
       NORMAL C3/5, B=128, natural order, each reached through
       `make_decoder_nb`'s automatic choice: 12 sweeps at sigma 0.65, and
       6 sweeps beyond the code's threshold (sigma 0.74 at C2/3, 0.82 at
       C3/5), where some codewords must stay undecoded;
       K5 (fixed, bf16 LLRs staged in, bf16 c2v) at NORMAL C2/3 through
       `make_decoder_nb_fused_io`, the same two cases;
       K6 (FFT stage 1 fused with the twiddle) on every n of `_FACTORS`
       and at ragged symbol counts, then at n=32768, 60 symbols, F=32
       frames against its plain version within `fft_stage1.compare`'s
       tolerance, stage 1 by K6 plus the stage-2 product against
       torch.fft.fft, and K6's time at F=32 and F=128 beside its bound
       and the same function through bf16 torch.matmul;
       K7 (the max-log LLR tail) at the benchmark cells' shape, the UK HD
       mode's 202 blocks and F=64 frames in bf16, against its plain
       version, tolerance 0 (NaN equal to NaN), with and without the EVM
       planes, timed beside its bound and the plain version;
       K8 (the front end's slice corrector) at the same cells' shape, the
       UK HD mode's 60 windows of 32768 samples and F=64 frames, bf16 out,
       against its plain version on the same arguments, tolerance 0, timed
       beside its bound, the plain version and the whole front end.
     Then the layered kernel body on every code `qc_tables` knows (13) at
     B=8 (`tools/ldpc_layer_bench.check_all_codes`): 3 fixed sweeps in
     natural order through K3's and K4's doors, the adaptive exit in
     reversed order through K2's door at a noise level where the batch
     needs several sweeps, and an explicit non-monotone layer order at
     SHORT C1/2 and NORMAL C5/6; tolerance 0.  K1's and K2's time per
     sweep and fixed part (a line through their 1 or 2, 9 or 10, and 24
     sweep cases), and the time of one layer at B=128 and at B=8, where 8
     CTAs have the card to themselves (`layer_times`); from the latter
     each layered kernel's dependency-chain floor (`[chain floor]`: the
     layers of one codeword run one after another on one SM), printed
     beside its roofline bound.
  3. the superstep: F frames modulated on the host (T2Modulator), impaired
     on the card (CFO +1.2 kHz, SCO +22 ppm, DC, IQ imbalance, int16 ADC),
     tracking state estimated by T2Receiver.refine_acquire on a 2-frame
     capture, then the superstep at clean, at 20 dB and at 19 dB with a
     static 0.15@32 echo.  Gates at every point: every codeword
     BCH-clean, per-frame hashes equal to the host expectation, the TS
     reassembled from all frames bit-exact, K1 launched.  Then K5's
     path, its front door on the superstep's own frame-0 LLRs (every
     codeword BCH-clean, the BB bytes equal to the transmitted ones), and
     K6's path, the FFT microbench tool (`tools/fft_microbench.run`: every
     route's error against an f64 FFT within its bound).
  4. the receiver: `DeviceT2Receiver(device="cuda")` on a host-modulated
     capture of the headline mode: `receive()` at CFO +1.2 kHz and 20 dB
     (K2), `receive()` with adaptive=False on the clean capture (K3), the
     same at NORMAL C3/5 (K4), and the streaming batched path through
     `io.devices.StreamingReceiver` at 30 dB.  Gates: every frame decoded,
     no TS errors, the TS a bit-exact prefix of the transmitted one, the
     route's kernel launched, at least one batched superstep.
  5. streaming with the sample correction on the card: the capture
     resampled to the 9.2 Msps SdrPlay rate (the drift stage; LO offset,
     DC and IQ imbalance injected by `SimulatedDevice`) and to the 10 Msps
     AirSpy rate (the 35/32 polyphase stage).  Gates: the chain that ran is
     `DeviceFrontendChain` with its state on the CUDA device, every frame
     decoded (all but at most the last at 10 Msps, whose tail the
     polyphase halo holds back), no TS errors, the TS bit-exact.
  6. the receiver CLI (`rx.cli`, as a user runs it): `tx.cli` writes a
     4-frame capture at the headline mode; `--flood-ldpc` one-shot on its
     first frame (the host receiver and the f32 flooding decoder on the
     card) and `--stream --device-path` on all of it (K2).  Gates: every
     frame decoded, each TS bit-exact, K2 launched.
  7. the entry hooks and the data-parallel step: `entry()` ((8, 64800)
     bits, ms per call), `dryrun_multichip(1)` (a spawned NCCL rank: tiny
     mode and flagship shape), and `sharded_fused_step` in a world-1 NCCL
     group at the headline mode with the front end on, 8 frames impaired by
     SCO 2e-5.  Gates: every codeword equal to the transmitted one, the
     stats all-reduce equal to the transmitted ones and codewords, the
     bits equal to the same modules with no process group, the flooding
     decoder's bits on the card equal to the CPU's (bf16 and f32).
     Then the v1 step (`sharded_receive_step`, the dryrun's part 2) in a
     world-1 NCCL group on 2 of those frames, un-impaired, 2 f32 flooding
     iterations: its bits equal to the same step on the CPU and to the
     transmitted codewords.
  8. the BER tool (`tools/ber_validation`) at NORMAL C2/3, B=128: K3, the
     bf16 flooding decoder, K1 on the reversed layers.  Gate: each layered
     column within 10% of flooding wherever that is at least 1e-3.
  9. two-process streaming (`tools/concurrent_stream_bench`, ranks of a
     gloo group sharing cuda:0, each with DeviceT2Receiver: K2) at the
     headline mode: the handoff (8 frames, rank 0 streams 4 blocks and
     broadcasts its checkpoint, rank 1 resumes) and the concurrent slices
     (8 frames, 2 per slice, 2 rounds, CFO 600 Hz, SCO 20 ppm, 30 dB).
     Gates: the TS bit-exact against one process on the same capture, no
     TS errors, K2 launched in each rank; concurrent: both ranks' CFO
     history equal, and moving.  Prints the per-round walltimes.
  10. the microbenches at the headline mode: `demod_split_microbench` at
     F=128 with the cuFFT and the K6 head (gate: the llr prefix equals
     `MultiFramePath.syms`), `path_microbench` (F=8) and
     `demod_microbench` (F=32), `fec_tail_microbench` (gates: every
     codeword BCH-clean, per-frame and grouped hashes equal),
     `ldpc_microbench` (K3 against K4; gate: both decode exactly),
     `hbm_vmem_equivalence` (gate: K4 equal to the f32 layered reference,
     errors corrected) and one row (19 dB) of `ldpc_iters_sweep`.
  11. no jax module and no module of the JAX package is loaded.
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_BLOCKS = 128
PALLAS = "sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py"
SOURCE = "sdr_receiver_dvb_t2_tpu_torch/csrc/ldpc_layered.cu"
SOURCE_K6 = "sdr_receiver_dvb_t2_tpu_torch/csrc/fft_stage1.cu"
SOURCE_K7 = "sdr_receiver_dvb_t2_tpu_torch/csrc/llr_tail.cu"
SOURCE_K8 = "sdr_receiver_dvb_t2_tpu_torch/csrc/frontend_correct.cu"
# published peaks of one H100 SXM, for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
# f32 operations of the layered kernels per edge and sweep (subtract; abs,
# compare, two-minimum update and sign count; abs, compare, two selects,
# multiply and the bf16 rounding of the new message; the two-operation
# write-back) and per edge of one syndrome pass
OPS_PER_EDGE_SWEEP = 15
OPS_PER_EDGE_CHECK = 2
FFT_FRAMES = 32            # frames of the K6 check and the FFT microbench
K7_BLOCKS = 202            # K7's check at the benchmark cells' shape:
K7_FRAMES = 64             # the UK HD mode's blocks, F frames per step
K8_FRAMES = 64             # K8's check at the cells' shape: F per step
STREAM_FRAMES = 4          # frames of the vendor-rate streaming captures
STREAM_TAIL = 4096         # samples of the next frame played after the last
CLI_FRAMES = 4             # frames of the capture the CLI phase writes
SHARD_FRAMES = 8           # frames of the sharded step at the flagship shape
SHARD_SCO = 2e-5           # the sharded step's fixed sample-clock offset
SHARD_INV_NVAR = 1.0e3     # its LLR scale on the clean (int16) frames
V1_FRAMES = 2              # frames of the v1 step (the dryrun's part 2)
STREAM_DIST_FRAMES = 8     # frames of each two-process streaming capture
SPLIT_FRAMES = 128         # frames of the demod + LLR stage split
TOOL_REPS = 2              # timed steps per microbench prefix
# the noise cases of the adaptive kernels: (label, sigma, traced floor)
NOISE_CASES = (("clean", 0.0, 0), ("sigma 0.65", 0.65, 0),
               ("sigma 0.74", 0.74, 0), ("sigma 0.65 floor 8", 0.65, 8))


def log(msg):
    print(msg, flush=True)


def kernel_wrappers():
    """{name: the launch-counting wrapper} of K1-K8 (the package's table)."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import kernel_wrappers as table
    return table()


def ldpc_bound(code, batch, in_bytes, sweeps, checks=0):
    """The least time the card could take for one layered decode: the
    larger of its bytes (LLRs read once, bits written once) over the
    memory rate and its f32 operations over the f32 rate, for the sweeps
    and syndrome passes this run's data needed.
    -> (bound ms, "bytes" or "operations")."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as ll
    tab = ll.qc_tables(*code)
    edges = int((tab.layer_deg + 2).sum()) * 360
    ops = edges * batch * (OPS_PER_EDGE_SWEEP * sweeps
                           + OPS_PER_EDGE_CHECK * checks)
    byts = tab.n * batch * (in_bytes + 1)
    t_ops, t_bytes = ops / F32_FLOPS, byts / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_build():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    log(out.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    from sdr_receiver_dvb_t2_tpu_torch import _build
    t0 = time.time()
    _build.build_all()
    log(f"[build] csrc/*.cu in parallel in {time.time() - t0:.2f} s")
    for name in ("ldpc_layered", "fft_stage1", "llr_tail",
                 "frontend_correct"):
        _build.load(name)
        lines = _build.build_log(name).splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln and "registers" in ln]
        spills = [int(ln.split(" bytes spill stores")[0].split()[-1])
                  for ln in lines if "bytes spill stores" in ln]
        log(f"[build] {name}.cu ptxas: {len(regs)} kernels, registers "
            f"{min(regs)}..{max(regs)}; {sum(b > 0 for b in spills)} of "
            f"{len(spills)} functions spill, at most {max(spills)} bytes")
    from sdr_receiver_dvb_t2_tpu_torch.ops import fft_stage1
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    plan = fft_stage1.plan(256, 128, FFT_FRAMES * mb.S)
    log(f"[build] K6 at 256 x 128: {plan['warpgroups']} consumer "
        f"warpgroups + 1 producer warp per CTA, {plan['smem']} B of dynamic "
        f"shared memory (W1^T bands, a ring of {plan['stages']} stages, the "
        f"output tiles), {plan['ctas']} persistent CTAs")


def _diff(a, b):
    return int((a.int() - b.int()).abs().max())


def phase_adaptive(tag, dec, code, dtype, seed):
    """An adaptive kernel (K1 or K2) against its plain version on the
    noise cases; tolerance 0 (bits and sweep counts are integers).
    -> the kernel's record: worst |diff|, and at sigma 0.65 the kernel's
    and the plain version's ms, the kernel's bound and (`_layers`, not part
    of the printed record) the layers one codeword ran."""
    from sdr_receiver_dvb_t2_tpu_torch.tools import ldpc_layer_bench as lb
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    cw = benchgen.codewords(*code, NUM_BLOCKS, seed=seed)
    rng = np.random.default_rng(seed)
    worst, timed, by_sweeps = 0, None, []
    in_bytes = torch.finfo(dtype).bits // 8
    for label, sigma, floor in NOISE_CASES:
        v = lb.channel_llrs(cw, sigma, rng, dtype)
        kb, kit = dec.kernel(v, floor)
        pb, pit = dec.plain(v, floor)
        torch.cuda.synchronize()
        err = max(_diff(kb, pb), abs(int(kit) - int(pit)))
        worst = max(worst, err)
        ok_cw = int((kb.cpu().numpy().T == cw).all(axis=1).sum())
        k_ms = lb.cuda_ms(lambda: dec.kernel(v, floor), 5)
        p_ms = lb.cuda_ms(lambda: dec.plain(v, floor), 1)
        log(f"[{tag} vs plain] {code[0].name} {code[1].name} B={NUM_BLOCKS} "
            f"{label}: sweeps kernel {int(kit)} plain {int(pit)}, max |diff| "
            f"{err} (tolerance 0), {ok_cw}/{NUM_BLOCKS} codewords decoded; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if err != 0:
            raise RuntimeError(f"{tag} disagrees with its plain version "
                               f"({label})")
        if floor == 0:
            by_sweeps.append((int(kit), k_ms))
        if label == "sigma 0.65":
            sweeps = int(kit)
            bound, by = ldpc_bound(code, NUM_BLOCKS, in_bytes, sweeps,
                                   checks=sweeps // dec.check_every)
            timed = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None,
                     "_layers": sweeps * dec.tab.q}
    slope, fixed = lb.line_fit(by_sweeps)
    log(f"[{tag} per sweep] "
        + ", ".join(f"{n} sweeps {t:.3f} ms" for n, t in by_sweeps)
        + f": {slope:.4f} ms per sweep (with its syndrome pass"
        + ("" if dec.check_every == 1
           else f" every {dec.check_every} sweeps")
        + f") + {fixed:.4f} ms fixed")
    return {"max_abs_err": worst, **timed}


def phase_all_codes():
    """The layered kernel body on every code at B=8 against the plain
    version (tolerance 0; raises on a disagreement), then what one layer
    costs at the headline code and at K4's.
    -> {rate name: the least time of one layer in us}: the slope at B=8,
    where no other CTA competes for the card."""
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import CodeRate, FECFrame
    from sdr_receiver_dvb_t2_tpu_torch.tools import ldpc_layer_bench as lb
    t0 = time.time()
    records = lb.check_all_codes(log=log)
    codes = {r["code"] for r in records}
    log(f"[all codes] {len(records)} cases on {len(codes)} codes equal to "
        f"the plain version in {time.time() - t0:.1f} s")
    if len(codes) != 13:
        raise RuntimeError(f"the all-codes phase ran {len(codes)} codes")
    least = {}
    for rate, variant in ((CodeRate.C2_3, "vmem"), (CodeRate.C3_5, "hbm")):
        for r in lb.layer_times(FECFrame.NORMAL, rate, variant):
            least[rate.name] = min(least.get(rate.name, r["us_per_layer"]),
                                   r["us_per_layer"])
            log(lb.layer_times_line(FECFrame.NORMAL, rate, variant, r))
    return least


def phase_fixed(tag, rate, variant, sigma_hard, seed):
    """A fixed-iteration kernel against its plain version, tolerance 0 on
    bits: K3 or K4 through `make_decoder_nb`'s automatic choice (`variant`
    "vmem" or "hbm"), or K5 through `make_decoder_nb_fused_io` (`variant`
    "fused_io").  12 sweeps at sigma 0.65 (timed), and 6 sweeps at
    `sigma_hard`, beyond the code's threshold, where codewords must stay
    undecoded (bits that have not settled on the transmitted word show any
    numerical difference).
    -> the kernel's record, as `phase_adaptive` gives it."""
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import FECFrame
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered
    from sdr_receiver_dvb_t2_tpu_torch.tools import ldpc_layer_bench as lb
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    cw = benchgen.codewords(FECFrame.NORMAL, rate, NUM_BLOCKS, seed=seed)
    rng = np.random.default_rng(seed)
    worst, timed = 0, None
    for sigma, sweeps in ((0.65, 12), (sigma_hard, 6)):
        if variant == "fused_io":
            dec = ldpc_layered.make_decoder_nb_fused_io(
                FECFrame.NORMAL, rate, iters=sweeps, batch=NUM_BLOCKS)
            what = "bf16 LLRs staged in, c2v torch.bfloat16"
        else:
            dec = ldpc_layered.make_decoder_nb(
                FECFrame.NORMAL, rate, iters=sweeps, batch=NUM_BLOCKS)
            if dec.core.variant != variant:
                raise RuntimeError(
                    f"make_decoder_nb chose {dec.core.variant} at NORMAL "
                    f"{rate.name}, expected {variant}")
            what = f"auto choice {variant!r} (c2v {dec.core.c2v_dtype})"
        # K5 gets f32 LLRs too: its front door rounds them to bf16
        v = lb.channel_llrs(cw, sigma, rng, torch.float32)
        kb, pb = dec.kernel(v), dec.plain(v)
        torch.cuda.synchronize()
        err = _diff(kb, pb)
        worst = max(worst, err)
        wrong = kb.cpu().numpy().T != cw
        ok_cw = int((~wrong).all(axis=1).sum())
        line = (f"[{tag} vs plain] NORMAL {rate.name} B={NUM_BLOCKS} sigma "
                f"{sigma}, {what}, {sweeps} sweeps: max |diff| {err} "
                f"(tolerance 0), {ok_cw}/{NUM_BLOCKS} codewords decoded, "
                f"{int(wrong.sum())} bits off the transmitted words")
        if sweeps == 12:
            bound, by = ldpc_bound((FECFrame.NORMAL, rate), NUM_BLOCKS,
                                   2 if variant == "fused_io" else 4, sweeps)
            timed = {"ms": lb.cuda_ms(lambda: dec.kernel(v), 5),
                     "plain_ms": lb.cuda_ms(lambda: dec.plain(v), 1),
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "_layers": sweeps * dec.tab.q}
            line += (f"; kernel {timed['ms']:.3f} ms, plain "
                     f"{timed['plain_ms']:.3f} ms, bound {bound:.4f} ms")
        log(line)
        if err != 0:
            raise RuntimeError(f"{tag} disagrees with its plain version "
                               f"(sigma {sigma})")
        if sigma == sigma_hard and ok_cw == NUM_BLOCKS:
            raise RuntimeError(f"{tag}: every codeword decoded at sigma "
                               f"{sigma}; the check does not discriminate")
    return {"max_abs_err": worst, **timed}


def k6_bound(f, n1, n2):
    """K6's least time at (f, 60, n1*n2): its bytes (y read and b written
    once, bf16, and the tables) over the memory rate against its bf16
    tensor operations over the tensor rate.  -> (ms, "bytes" or
    "operations", bytes, operations)."""
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    n = n1 * n2
    byts = 2 * (4 * f * mb.S * n + 2 * n1 * n1 + 2 * n1 * n2)
    ops = f * mb.S * (4 * 2 * n1 * n1 * n2 + 6 * n)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations", \
        byts, ops


def phase_k6(frames):
    """K6 on every n of `_FACTORS` and at ragged symbol counts against its
    plain version (`tools/fft_microbench.check_factors`), then at full
    width (n=32768 as 256 x 128, 60 symbols, each F of `frames`) against
    its plain version within `fft_stage1.compare`'s tolerance (one bf16 ulp
    of the larger magnitude plus 2^-18 of the plane's peak; under 1% of
    the elements differing at all); stage 1 by K6 plus the stage-2 product
    against torch.fft.fft; times of the kernel and of the same function
    through bf16 torch.matmul, beside the bound, at each F, and of the
    plain version at the first.  -> the kernel's record at the first F."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import fft_stage1, mxu_fft
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    t0 = time.time()
    cases = mb.check_factors(log=log)
    log(f"[K6 factors] {len(cases)} cases on {len(mxu_fft._FACTORS)} "
        f"lengths within the tolerance in {time.time() - t0:.1f} s")
    n, s = mb.N, mb.S
    stage = fft_stage1.Stage1(n)
    n1, n2 = stage.n1, stage.n2
    record = None
    for f in frames:
        gen = torch.Generator(device="cuda").manual_seed(9)
        xr = torch.randn((f, s, n), generator=gen, device="cuda")
        xi = torch.randn((f, s, n), generator=gen, device="cuda")
        yr, yi = stage._input(xr, xi)
        tabs, packed = stage.tables("cuda"), stage.packed("cuda")
        k_ms = mb.cuda_ms(
            lambda: fft_stage1.fft_stage1_cuda(yr, yi, *packed), 10)
        l_ms = mb.cuda_ms(lambda: mb.stage1_matmul_bf16(yr, yi, *tabs), 10)
        bound, by, byts, ops = k6_bound(f, n1, n2)
        plan = fft_stage1.plan(n1, n2, f * s)
        log(f"[K6 timing] F={f}: kernel {k_ms:.3f} ms = {k_ms / f:.4f} "
            f"ms/frame, bf16 torch.matmul route {l_ms:.3f} ms = "
            f"{l_ms / f:.4f} ms/frame, bound {bound:.3f} ms ({by}; "
            f"{byts / 1e6:.0f} MB, {ops / 1e9:.0f} GFLOP), "
            f"{100 * bound / k_ms:.0f}% of the bound's rate; launch "
            f"{plan['ctas']} CTAs x {plan['warpgroups']} warpgroups, "
            f"tile {plan['tile']}, {plan['stages']} stages, "
            f"{plan['smem']} B shared")
        if record is not None:
            continue
        kr, ki = stage.kernel(xr, xi)
        pr, pi = stage.plain(xr, xi)
        torch.cuda.synchronize()
        res = [fft_stage1.compare(kr, pr), fft_stage1.compare(ki, pi)]
        err = max(r["max_abs_err"] for r in res)
        frac = max(r["frac_differ"] for r in res)
        beyond = sum(r["n_beyond"] for r in res)
        log(f"[K6 vs plain] ({f}, {s}, {n}) as {n1} x {n2}: max |diff| "
            f"{err:.4g} (peak {float(pr.float().abs().max()):.4g}), "
            f"{100 * frac:.4f}% of elements differ, {beyond} beyond the "
            f"tolerance")
        if not all(r["ok"] for r in res):
            raise RuntimeError("K6 disagrees with its plain version")
        out_r, out_i = mxu_fft.stage2_carrier_major(kr[:2], ki[:2], n)
        ref = torch.fft.fft(torch.complex(xr[:2].double(), xi[:2].double()),
                            dim=-1).permute(2, 1, 0)
        got = torch.complex(out_r.double(), out_i.double())
        rel = float((got - ref).abs().pow(2).mean().sqrt()
                    / ref.abs().pow(2).mean().sqrt())
        log(f"[K6 + stage 2 vs torch.fft.fft] relative RMS error {rel:.3e} "
            f"(bound 1e-2: bf16 input, twiddled stage and output)")
        if not rel < 1e-2:
            raise RuntimeError("K6 plus stage 2 is not the FFT")
        p_ms = mb.cuda_ms(lambda: fft_stage1.stage1_plain(yr, yi, *tabs), 2)
        log(f"[K6 timing] F={f}: plain version (f32 matmul) {p_ms:.3f} ms")
        record = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": l_ms}
        del kr, ki, pr, pi
    return record


def k7_bound(cells, f, bits, elem):
    """K7's least time: the paired cells (2 values) read once and the LLRs
    (`bits` values) written once per cell and frame, over the memory rate.
    -> (ms, bytes)."""
    byts = cells * f * elem * (2 + bits)
    return 1e3 * byts / HBM_BYTES_PER_S, byts


def phase_k7():
    """K7 at the benchmark cells' shape (`K7_BLOCKS`, `K7_FRAMES`, bf16) on
    random unit-power cells against its plain version, tolerance 0 (NaN
    equal to NaN), with and without the EVM planes; the kernel's time and
    the plain version's beside the bound.  -> the kernel's record."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import llr_tail
    from sdr_receiver_dvb_t2_tpu_torch.rx import fusedpath
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    from sdr_receiver_dvb_t2_tpu_torch.tools.timing import differing
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg
    p, plp = bg.headline_mode(K7_BLOCKS)
    path = fusedpath.get_fused_plp_path(p, plp, K7_BLOCKS)
    tail = llr_tail.LLRTail(path, K7_FRAMES, torch.bfloat16)
    total = fusedpath.get_fused_demod(p).total_cells
    gen = torch.Generator(device="cuda").manual_seed(17)
    both = (0.8 * torch.randn((total, 2 * K7_FRAMES), generator=gen,
                              device="cuda")).to(torch.bfloat16)
    inv = torch.tensor(100.0, device="cuda")
    n_diff, err = 0, 0.0
    for evm in (True, False):
        got, got_evm = tail.kernel(both, inv, evm)
        want, want_evm = tail.plain(both, inv)
        n_diff += differing(got, want)
        if evm:
            n_diff += differing(got_evm, want_evm)
        g, w = got.float(), want.float()
        same = (g == w) | (g.isnan() & w.isnan())
        err = max(err, float(torch.where(same, 0.0, (g - w).abs()).max()))
        del got, want, g, w, same
    k_ms = mb.cuda_ms(lambda: tail.kernel(both, inv, False), 10)
    e_ms = mb.cuda_ms(lambda: tail.kernel(both, inv, True), 10)
    p_ms = mb.cuda_ms(lambda: tail.plain(both, inv), 2)
    n_points = tail.nb * tail.cpf
    bound, byts = k7_bound(n_points, K7_FRAMES, plp.bits_per_cell, 2)
    log(f"[K7 vs plain] {tail.cpf} cells x {tail.nb} blocks x {K7_FRAMES} "
        f"frames, 256QAM rotated, bf16: {n_diff} values differ, max |diff| "
        f"{err} (tolerance 0)")
    log(f"[K7 timing] kernel {k_ms:.3f} ms = {k_ms / K7_FRAMES:.4f} "
        f"ms/frame ({e_ms:.3f} ms with the EVM planes), plain version "
        f"{p_ms:.3f} ms, bound {bound:.3f} ms (bytes; {byts / 1e9:.3f} GB), "
        f"{100 * bound / k_ms:.0f}% of the bound's rate")
    if n_diff or err:
        raise RuntimeError("K7 disagrees with its plain version")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def k8_bound(f, windows, slice_len, out_len, elem):
    """K8's least time: each window's span of the two f32 raw planes read
    once and the two symbol planes written once, over the memory rate.
    -> (ms, bytes)."""
    byts = f * windows * (2 * 4 * slice_len + 2 * elem * out_len)
    return 1e3 * byts / HBM_BYTES_PER_S, byts


def phase_k8():
    """K8 at the benchmark cells' shape (the UK HD mode's windows, the
    superstep's symbol order, `K8_FRAMES`, bf16 out) on random raw planes
    with a DC offset, against its plain version on the arguments the front
    end handed it, tolerance 0; the kernel's time and the plain version's
    beside the bound, and the whole front end's (the eager DC/IQ estimate
    and small terms, then K8).  -> the kernel's record."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as fd
    from sdr_receiver_dvb_t2_tpu_torch.rx import fusedpath
    from sdr_receiver_dvb_t2_tpu_torch.rx.superstep import HALF
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    from sdr_receiver_dvb_t2_tpu_torch.tools.timing import differing
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg
    p, _ = bg.headline_mode(K7_BLOCKS)
    fe = fd.make_frontend_symbols(
        p.len_frame, p.symbol_size, p.guard_size, bg.FS, half=HALF,
        sym_order=fusedpath.get_fused_demod(p).sym_order,
        out_dtype=torch.bfloat16)
    n_in = fd.frontend_raw_len(p.frame_samples, bg.SCO, HALF)
    gen = torch.Generator(device="cuda").manual_seed(19)
    raw = [0.3 * torch.randn((K8_FRAMES, n_in), generator=gen,
                             device="cuda") + dc for dc in (0.01, -0.007)]
    track = torch.tensor([bg.CFO_HZ, 1 + bg.SCO, HALF * (1 + bg.SCO),
                          bg.PHASE0], device="cuda")
    corr, seen = fe.correct, []

    def kernel(*a):
        seen.append(a)
        return type(corr).kernel(corr, *a)

    corr.kernel = kernel
    try:
        (got_r, got_i), _, _ = fe(*raw, *track)
    finally:
        del corr.kernel
    args, = seen
    want_r, want_i = corr.plain(*args)
    n_diff = differing(got_r, want_r) + differing(got_i, want_i)
    err = max(float((got_r.float() - want_r.float()).abs().max()),
              float((got_i.float() - want_i.float()).abs().max()))
    del got_r, got_i, want_r, want_i
    k_ms = mb.cuda_ms(lambda: corr.kernel(*args), 10)
    p_ms = mb.cuda_ms(lambda: corr.plain(*args), 2)
    fe_ms = mb.cuda_ms(lambda: fe(*raw, *track), 10)
    windows, out_len = p.len_frame, corr.out_len
    bound, byts = k8_bound(K8_FRAMES, windows, corr.slice_len, out_len, 2)
    log(f"[K8 vs plain] {windows} windows x {out_len} samples x "
        f"{K8_FRAMES} frames, bf16 out: {n_diff} values differ, max |diff| "
        f"{err} (tolerance 0)")
    log(f"[K8 timing] kernel {k_ms:.3f} ms = {k_ms / K8_FRAMES:.4f} "
        f"ms/frame, plain version {p_ms:.3f} ms, bound {bound:.3f} ms "
        f"(bytes; {byts / 1e9:.3f} GB), {100 * bound / k_ms:.0f}% of the "
        f"bound's rate; the whole front end {fe_ms:.3f} ms = "
        f"{fe_ms / K8_FRAMES:.4f} ms/frame")
    if n_diff or err:
        raise RuntimeError("K8 disagrees with its plain version")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def phase_kernels():
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import CodeRate
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as ll
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    _, plp = benchgen.headline_mode(NUM_BLOCKS)
    code = (plp.fec_frame, plp.rate)
    return {
        "K1": phase_adaptive("K1", ll.make_adaptive_decoder_nb_fused_io(
            *code, max_iters=24, check_every=1, batch=NUM_BLOCKS,
            layer_order="reversed"), code, torch.bfloat16, 5),
        "K2": phase_adaptive("K2", ll.make_adaptive_decoder_nb_fused(
            *code, max_iters=24, check_every=2, batch=NUM_BLOCKS,
            layer_order="reversed"), code, torch.float32, 6),
        "K3": phase_fixed("K3", CodeRate.C2_3, "vmem", 0.74, 7),
        "K4": phase_fixed("K4", CodeRate.C3_5, "hbm", 0.82, 8),
        "K5": phase_fixed("K5", CodeRate.C2_3, "fused_io", 0.74, 9),
        "K6": phase_k6((FFT_FRAMES, 4 * FFT_FRAMES)),
        "K7": phase_k7(),
        "K8": phase_k8(),
    }


def phase_slice(n_frames):
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered
    from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as ss_mod
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    t0 = time.time()
    p, plp = bg.headline_mode(NUM_BLOCKS)
    ts, frames, rows = bg.modulate(p, plp, n_frames)
    log(f"[slice] modulated {n_frames} frames x {p.frame_samples} samples "
        f"on the host in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    t0 = time.time()
    track, (cfo, ratio, pos0) = bg.estimate_tracking(frames, 10 ** -2.0, gen,
                                                     "cuda")
    log(f"[slice] acquisition at 20 dB in {time.time() - t0:.1f} s: cfo "
        f"{cfo:+.2f} Hz (err {cfo - bg.CFO_HZ:+.3f}), sco "
        f"{(ratio - 1) * 1e6:+.3f} ppm (err {(ratio - 1 - bg.SCO) * 1e6:+.3f}"
        f"), frame start {pos0:.2f} "
        f"(err {pos0 - ss_mod.HALF * (1 + bg.SCO):+.2f})")

    weights = ss_mod.hash_weights(plp.fec.k_bch // 8, NUM_BLOCKS)
    expect = np.stack([ss_mod.expected_hash(rows[f], weights)
                       for f in range(n_frames)])
    step = ss_mod.Superstep(p, plp, NUM_BLOCKS, n_frames, bg.FS, weights)
    # (label, AWGN relative to the signal, inv_nvar, static echo)
    points = (("clean", 0.0, 10 ** 3.3, (0.0, 0)),
              ("20 dB", 10 ** -2.0, 100.0, (0.0, 0)),
              ("19 dB echo 0.15@32", 10 ** -1.9, 10 ** 1.9, (0.15, 32)))
    raws = {lab: bg.impaired(frames, nv, gen, "cuda", echo=echo)
            for lab, nv, _, echo in points}
    keep = tuple(range(n_frames))

    counts = _zero_counts()
    results = {lab: step(*raws[lab], inv, track, keep=keep)
               for lab, _, inv, _ in points}
    torch.cuda.synchronize()
    launches = _read_counts(counts)
    if launches["K1"] == 0:
        raise RuntimeError("the superstep never launched K1")

    for lab, _, inv, _ in points:
        sums, oks, iters, byts = (r.cpu().numpy() for r in results[lab])
        got = bg.reassemble_ts(byts)
        ts_ok = (len(got) >= (n_frames - 1) * len(ts) // n_frames
                 and np.array_equal(got, ts[:len(got)]))
        hash_ok = bool((sums == expect).all())
        bch_ok = bool((oks == NUM_BLOCKS).all())
        dt = mb.cuda_ms(lambda: step(*raws[lab], inv, track), 3)
        log(f"[slice {lab}] BCH clean {oks.min()}..{oks.max()}/{NUM_BLOCKS}"
            f"; hashes {'ok' if hash_ok else 'FAIL'} x{n_frames}; TS "
            f"bit-exact={ts_ok} ({len(got)} of {len(ts)} bytes); LDPC "
            f"{float(iters) / n_frames:.2f} sweeps/frame; superstep "
            f"{dt:.2f} ms = {dt / n_frames:.3f} ms/frame")
        if not (bch_ok and hash_ok and ts_ok):
            raise RuntimeError(f"slice gate failed at {lab}")

    # the kernel on the main path's own LLRs (frame 0, 20 dB)
    (sr, si), _, _ = step.frontend(*raws["20 dB"], track[0], track[1],
                                   track[2], track[3])
    llr0 = step.mf.syms(sr, si, 100.0)[:, :, 0].contiguous()
    kb, kit = step.decode.kernel(llr0, 8)
    pb, pit = step.decode.plain(llr0, 8)
    err = max(_diff(kb, pb), abs(int(kit) - int(pit)))
    log(f"[slice] K1 on frame-0 LLRs at 20 dB: sweeps kernel {int(kit)} "
        f"plain {int(pit)}, max |diff| {err} (tolerance 0)")
    if err != 0:
        raise RuntimeError("K1 disagrees with its plain version on the "
                           "main path's LLRs")

    # K5's path is its own front door: the fixed decoder on the same LLRs
    dec5 = ldpc_layered.make_decoder_nb_fused_io(plp.fec_frame, plp.rate,
                                                 iters=12, batch=NUM_BLOCKS)
    counts = _zero_counts()
    bits5 = dec5(llr0)
    torch.cuda.synchronize()
    launches["K5"] = _read_counts(counts)["K5"]
    ok5 = int(step.bch_check(bits5[:plp.fec.n_bch]).sum())
    bytes5 = step.bb_pack(bits5).cpu().numpy().T.astype(np.uint8)
    same5 = np.array_equal(bytes5, rows[0])
    err5 = _diff(bits5, dec5.plain(llr0))
    log(f"[K5 path] make_decoder_nb_fused_io, 12 sweeps on frame-0 LLRs at "
        f"20 dB: BCH clean {ok5}/{NUM_BLOCKS}, BB bytes equal to the "
        f"transmitted ones: {same5}, max |diff| to plain {err5} (tolerance "
        f"0), launches {launches['K5']}")
    if ok5 != NUM_BLOCKS or not same5 or err5 != 0 or launches["K5"] == 0:
        raise RuntimeError("K5 path gate failed")
    return launches, max(err, err5)


def phase_fft_tool(f):
    """K6's path: the FFT microbench tool at (f, 60, 32768), its table
    printed; gates on every route's error against the f64 FFT.
    -> K6's launch count."""
    from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench as mb
    counts = _zero_counts()
    table = mb.run(f)
    torch.cuda.synchronize()
    launches = _read_counts(counts)["K6"]
    # f32 routes: f32 rounding through a 32K-point transform; bf16 routes:
    # the 2^-9 input and intermediate roundings
    limits = {"cufft f32 + bf16 cast + transpose": 1e-2,
              "matmul fft bf16": 2e-2, "matmul fft f32": 1e-4,
              "k6 stage 1 + stage 2": 1e-2}
    for name, r in table.items():
        err = "" if r["rel_err"] is None else f", err {r['rel_err']:.2e}"
        log(f"[fft microbench F={f}] {name}: {r['ms']:.3f} ms = "
            f"{r['ms'] / f:.4f} ms/frame{err}")
        if name in limits and not r["rel_err"] < limits[name]:
            raise RuntimeError(f"fft microbench: {name} is off the f64 FFT")
    if launches == 0:
        raise RuntimeError("the FFT microbench never launched K6")
    return launches


def _zero_counts():
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def _read_counts(wrappers):
    return {k: fn.launches for k, fn in wrappers.items()}


def _timed_decodes(rx):
    """Wrap rx._decode_frame to record each per-frame decode's wall time
    (it ends in a host read-back, so the device work is inside)."""
    spent = []
    inner = rx._decode_frame

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        ok = inner(*a, **kw)
        spent.append(time.perf_counter() - t0)
        return ok
    rx._decode_frame = wrapped
    return spent


def _ts_gate(label, ts_got, ts_ref, frames, n_frames, ts_errors):
    exact = len(ts_got) > 0 and np.array_equal(ts_got, ts_ref[:len(ts_got)])
    log(f"[receiver {label}] frames decoded {frames}/{n_frames}, TS errors "
        f"{ts_errors}, TS bit-exact={exact} ({len(ts_got)} of {len(ts_ref)} "
        f"bytes)")
    if frames != n_frames or ts_errors != 0 or not exact:
        raise RuntimeError(f"receiver gate failed ({label})")


def run_receive(label, rx, y, ts, n_frames, kernel):
    """One `receive()` route with the counts zeroed just before it; gates
    and the per-frame path's time.  -> the route's launch counts."""
    spent = _timed_decodes(rx)
    counts = _zero_counts()
    t0 = time.perf_counter()
    res = rx.receive(y)
    wall = time.perf_counter() - t0
    launches = _read_counts(counts)
    _ts_gate(label, res.ts, ts, res.stats.frames_decoded, n_frames,
             res.stats.ts_errors)
    iters = [it for s in res.stats.plp_stats.values() for it in s.ldpc_iters]
    log(f"[receiver {label}] per-frame path (demod, LLRs, LDPC, host L1, "
        f"BCH and TS) {1e3 * np.mean(spent[1:]):.2f} ms/frame over frames "
        f"2-{len(spent)}, first frame {1e3 * spent[0]:.2f} ms (with the "
        f"table builds); receive() {wall:.2f} s with host acquisition; SNR "
        f"{np.mean(res.stats.snr_db):.2f} dB; launches {launches}"
        + (f"; LDPC sweeps/frame {np.mean(iters):.2f}" if iters else ""))
    if launches[kernel] == 0:
        raise RuntimeError(f"receiver route {label} never launched {kernel}")
    return launches


def phase_receiver(p, plp, plp_k4, n_frames, device, seed=11):
    """The port's DeviceT2Receiver on `device`: receive() at 20 dB (K2),
    adaptive=False on the clean capture (K3) and at `plp_k4`'s code (K4),
    and the streaming batched path.  -> launch counts summed over the
    routes."""
    from sdr_receiver_dvb_t2_tpu_torch.io import devices
    from sdr_receiver_dvb_t2_tpu_torch.tx.modulator import apply_cfo, awgn
    from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import \
        DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    t0 = time.time()
    ts, frames, _ = bg.modulate(p, plp, n_frames, seed=seed)
    clean = np.concatenate(frames)
    ts4, frames4, _ = bg.modulate(p, plp_k4, 3, seed=seed + 1)
    log(f"[receiver] modulated {n_frames} frames at {plp.rate.name} and 3 "
        f"at {plp_k4.rate.name} on the host in {time.time() - t0:.1f} s")
    total = {k: 0 for k in kernel_wrappers()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    noisy = awgn(apply_cfo(clean, bg.CFO_HZ), 20.0, seed=seed)
    add(run_receive("20 dB, adaptive", DeviceT2Receiver(device=device),
                    noisy, ts, n_frames, "K2"))
    add(run_receive("clean, adaptive=False",
                    DeviceT2Receiver(device=device, adaptive=False),
                    clean, ts, n_frames, "K3"))
    add(run_receive(f"clean {plp_k4.rate.name}, adaptive=False",
                    DeviceT2Receiver(device=device, adaptive=False),
                    np.concatenate(frames4), ts4, 3, "K4"))

    rx = DeviceT2Receiver(device=device, stream_batch=2)
    got = []
    counts = _zero_counts()
    t0 = time.perf_counter()
    st = devices.StreamingReceiver(
        devices.SimulatedDevice(clean, snr_db=30), receiver=rx).run(
            ts_sink=got.append)
    wall = time.perf_counter() - t0
    launches = _read_counts(counts)
    add(launches)
    ts_got = np.concatenate(got) if got else np.zeros(0, np.uint8)
    _ts_gate("streaming, 30 dB", ts_got, ts, st.frames_decoded, n_frames,
             st.ts_errors)
    stages = st.metrics.stages
    per = {k: 1e3 * stages[k].seconds / max(stages[k].calls, 1)
           for k in ("frontend", "decode", "decode_batch") if k in stages}
    batch_frames = stages["decode_batch"].items / p.frame_samples \
        if "decode_batch" in stages else 0
    log(f"[receiver streaming] front end {st.frontend} "
        f"{1e3 * stages['frontend'].seconds / n_frames:.2f} ms/frame; "
        f"batched path "
        f"{1e3 * stages['decode_batch'].seconds / max(batch_frames, 1):.2f}"
        f" ms/frame over {rx.batch_supersteps} supersteps; per-frame path "
        f"{per.get('decode', 0.0):.2f} ms/frame; run {wall:.2f} s; "
        f"launches {launches}")
    if rx.batch_supersteps < 1 or launches["K2"] == 0:
        raise RuntimeError("the streaming run made no batched superstep "
                           "through K2")
    if st.frontend != "DeviceFrontendChain":
        raise RuntimeError(f"streaming ran {st.frontend}, not the device "
                           "front-end chain")
    return total


def phase_stream_frontend(p, plp, device, seed=21):
    """Streaming with the sample correction on the card: the headline
    capture resampled on the host to a vendor rate and played by a
    `SimulatedDevice` at that rate.  9.2 Msps (SdrPlay/Pluto, +0.625%: the
    drift stage) with LO offset, DC and IQ imbalance; 10 Msps (AirSpy,
    35/32: the polyphase stage) clean, one frame fewer and running on into
    the next frame's P1, because the two stages' stencils hold back more
    samples than the tracker forgives at the end of a capture.  Every frame
    played must decode.  -> launch counts summed."""
    from sdr_receiver_dvb_t2_tpu_torch.io import devices
    from sdr_receiver_dvb_t2_tpu_torch.rx import frontend as hostfe
    from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import \
        DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    ts, frames, _ = bg.modulate(p, plp, STREAM_FRAMES, seed=seed)
    clean = np.concatenate(frames)
    total = {k: 0 for k in kernel_wrappers()}
    routes = (
        ("9.2 Msps drift stage", 9.2e6, STREAM_FRAMES, 0, dict(
            lo_offset_hz=700.0, dc_offset=0.012 - 0.008j, iq_gain=1.02,
            iq_skew=0.012)),
        ("10 Msps 35/32 stage", 10.0e6, STREAM_FRAMES - 1, STREAM_TAIL, {}),
    )
    for label, rate, n_play, tail, impair in routes:
        t0 = time.time()
        x = hostfe.sinc_resample(clean[:n_play * p.frame_samples + tail],
                                 devices.SAMPLE_RATE / rate)
        t_res = time.time() - t0
        rx = DeviceT2Receiver(device=device, stream_batch=2)
        sr = devices.StreamingReceiver(
            devices.SimulatedDevice(x, snr_db=30, sample_rate=rate,
                                    **impair), receiver=rx)
        got = []
        counts = _zero_counts()
        t0 = time.perf_counter()
        st = sr.run(ts_sink=got.append)
        wall = time.perf_counter() - t0
        launches = _read_counts(counts)
        for k, v in launches.items():
            total[k] += v
        ts_got = np.concatenate(got) if got else np.zeros(0, np.uint8)
        exact = len(ts_got) > 0 and np.array_equal(ts_got, ts[:len(ts_got)])
        # the DC/IQ state mixes with every block's samples on the device,
        # so a state on the card after blocks ran means they were there too
        if st.frontend != "DeviceFrontendChain":
            raise RuntimeError(f"streaming ran {st.frontend}, not the "
                               f"device front-end chain ({label})")
        chain = sr.chain
        on_card = chain._blocks > 0 and chain._dciq_state.is_cuda
        fe = st.metrics.stages["frontend"]
        log(f"[stream {label}] host resample to {rate / 1e6:.1f} Msps "
            f"{t_res:.1f} s; front end {st.frontend}, {chain._blocks} "
            f"blocks corrected with the state on the card: {on_card}; "
            f"frames decoded {st.frames_decoded}/{n_play}, TS errors "
            f"{st.ts_errors}, TS bit-exact={exact} ({len(ts_got)} bytes); "
            f"front end {1e3 * fe.seconds / n_play:.2f} ms per frame played "
            f"over {fe.calls} blocks (the host CorrectorChain took 59-88 "
            f"ms/frame before the chain moved to the card); "
            f"cfo {st.cfo_hz:+.1f} Hz, IQ gain est {st.iq_gain_est:.4f}"
            f"; supersteps {rx.batch_supersteps}; run {wall:.2f} s; "
            f"launches {launches}")
        if (not on_card or st.frames_decoded != n_play
                or st.ts_errors != 0 or not exact
                or launches["K2"] == 0):
            raise RuntimeError(f"streaming front-end gate failed ({label})")
    return total


def phase_cli(p, plp, seed=31):
    """The receiver CLI as a user runs it: the port's `tx.cli` writes a
    CLI_FRAMES-frame capture at the headline mode, then `rx.cli` decodes it
    one-shot with `--flood-ldpc` (the host receiver with the f32 flooding
    decoder on the card; its first frame only, the host NumPy 256QAM
    demapper taking tens of seconds per frame) and with `--stream
    --device-path` (DeviceT2Receiver on the card: K2).  Gates: every frame
    decoded, no TS errors, each TS a bit-exact prefix of the transmitted
    one, K2 launched by the stream.  -> the stream's launch counts."""
    import contextlib
    import io
    import os
    import tempfile
    from sdr_receiver_dvb_t2_tpu_torch.rx import cli as rxcli
    from sdr_receiver_dvb_t2_tpu_torch.tx import cli as txcli
    from sdr_receiver_dvb_t2_tpu_torch.tx.modulator import T2Modulator

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(seed)
        ts = rng.integers(0, 256, (T2Modulator(p, [plp]).packets_needed(
            CLI_FRAMES) + 4, 188)).astype(np.uint8)
        ts[:, 0] = 0x47
        ts[:, 1] &= 0x7F
        ts = ts.reshape(-1)
        ts_in, cap = os.path.join(tmp, "in.ts"), os.path.join(tmp, "c.cf32")
        ts.tofile(ts_in)
        t0 = time.time()
        if txcli.main([ts_in, cap, "--blocks", str(NUM_BLOCKS),
                       "--extended", "--frames", str(CLI_FRAMES)]) != 0:
            raise RuntimeError("tx.cli failed")
        first = os.path.join(tmp, "frame0.cf32")
        np.fromfile(cap, np.complex64)[:p.frame_samples].tofile(first)
        log(f"[cli] tx.cli wrote {CLI_FRAMES} frames at 32K PP7 extended, "
            f"256QAM C2/3 NORMAL, {NUM_BLOCKS} blocks in "
            f"{time.time() - t0:.1f} s")
        launches = None
        for label, src, flags, n in (
                ("one-shot --flood-ldpc", first, ["--flood-ldpc"], 1),
                ("--stream --device-path", cap,
                 ["--stream", "--device-path"], CLI_FRAMES)):
            out = os.path.join(tmp, "out.ts")
            stdout = io.StringIO()
            counts = _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                rc = rxcli.main([src, "--out", out, *flags, "--stats-json"])
            wall = time.perf_counter() - t0
            run = _read_counts(counts)
            if rc != 0:
                raise RuntimeError(f"t2rx {label} exited {rc}")
            st = json.loads(stdout.getvalue().strip().splitlines()[-1])
            got = np.fromfile(out, np.uint8)
            exact = len(got) > 0 and np.array_equal(got, ts[:len(got)])
            log(f"[cli {label}] frames decoded {st['frames']}/{n}, TS "
                f"errors {st['ts_errors']}, TS bit-exact={exact} "
                f"({len(got)} bytes); host {1e3 * wall / n:.2f} ms per "
                f"frame ({wall:.2f} s for the run); launches {run}")
            if st["frames"] != n or st["ts_errors"] != 0 or not exact:
                raise RuntimeError(f"cli gate failed ({label})")
            launches = run
        if launches["K2"] == 0:
            raise RuntimeError("t2rx --stream --device-path never launched "
                               "K2")
    return launches


def phase_sharded(p, plp, seed=41):
    """The entry hooks and the data-parallel step: `entry()` on the card
    ((8, 64800) bits, ms per call); `dryrun_multichip(1)` (one NCCL rank
    in a spawned process: the tiny mode, then the flagship shape); then
    `sharded_fused_step` in a world-1 NCCL group at the headline mode with
    the front end on, SHARD_FRAMES host-modulated frames impaired by SCO
    2e-5 alone (the step's fixed front-end arguments), 4 f32 flooding
    iterations.  Gates: every codeword equal to the transmitted one, stats
    = (the transmitted ones, the codeword count), bits and local stats
    equal to `local_fused_step` run with no process group, and the
    flooding decoder's bits on the card equal to its bits on the CPU in
    both dtypes.  (The decoder's own time and its split by operator:
    `tools/ber_validation.py --profile`.)"""
    import torch.distributed as dist
    from sdr_receiver_dvb_t2_tpu_torch import entry
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2 import bbframe, bch, ldpc
    from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as fdev
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc as fldpc
    from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding
    from sdr_receiver_dvb_t2_tpu_torch.rx.p1_detect import P1_LEN
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    fn, args = entry.entry()
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        bits = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if bits.shape != (8, 64800) or bits.dtype != torch.uint8:
        raise RuntimeError(f"entry(): {tuple(bits.shape)} {bits.dtype}")
    log(f"[sharded] entry(): bits {tuple(bits.shape)} uint8; "
        f"{1e3 * np.median(times[1:]):.2f} ms per call (median of 3 after "
        f"the first, {1e3 * times[0]:.2f} ms)")

    torch.cuda.empty_cache()
    t0 = time.time()
    entry.dryrun_multichip(1)
    log(f"[sharded] dryrun_multichip(1): tiny mode and flagship shape on "
        f"one NCCL rank, shapes and stats ok, {time.time() - t0:.1f} s "
        f"with the process start")

    t0 = time.time()
    _, frames, rows = bg.modulate(p, plp, SHARD_FRAMES, seed=seed)
    fec = plp.fec
    bb = np.unpackbits(rows.reshape(-1, rows.shape[-1]), axis=1)
    cw = ldpc.encode(ldpc.get_code(plp.fec_frame, plp.rate),
                     bch.encode(plp.fec_frame,
                                bbframe.scramble(bb[:, :fec.k_bch]),
                                fec.t_bch))
    blen = p.len_frame * p.symbol_size
    body = torch.from_numpy(frames[:, P1_LEN:P1_LEN + blen]).cuda()
    clean = torch.nn.functional.pad(
        torch.stack([body.real, body.imag], -1).float(),
        (0, 0, 2 * sharding.HALF, 0))
    raw = fdev.make_impairer(fdev.frontend_raw_len(blen, SHARD_SCO), bg.FS,
                             half=sharding.HALF)(
        clean, 0.0, 1.0 + SHARD_SCO, 0.0, torch.zeros(2, device="cuda"),
        torch.tensor([1.0, 0.0], device="cuda"), None, 0.0)
    del body, clean
    log(f"[sharded] {SHARD_FRAMES} frames modulated, encoded and impaired "
        f"(SCO {SHARD_SCO:g}) in {time.time() - t0:.1f} s")

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        step = sharding.sharded_fused_step(
            p, plp, NUM_BLOCKS, SHARD_FRAMES, sharding.make_mesh(1),
            ldpc_iters=4, with_frontend=True, sco=SHARD_SCO)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            bits, stats = step(raw, SHARD_INV_NVAR)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    local = sharding.local_fused_step(p, plp, NUM_BLOCKS, SHARD_FRAMES,
                                      ldpc_iters=4, with_frontend=True,
                                      sco=SHARD_SCO)
    rbits, rstats = local(raw, SHARD_INV_NVAR)
    # the decoder on the card against the same on the CPU, in both dtypes,
    # on noisy words (equal bf16 magnitudes, where the first minimum
    # decides, are common): bits equal
    cw16 = bg.codewords(plp.fec_frame, plp.rate, 16, seed)
    noise = np.random.default_rng(seed).normal(0, 1.0, cw16.shape)
    x16 = torch.from_numpy(((2.0 / 0.8 ** 2) * (1.0 - 2.0 * cw16 + 0.8 * noise)
                            ).astype(np.float32))
    same_cpu = {str(dt).split(".")[1]: torch.equal(
        fldpc.make_decoder(plp.fec_frame, plp.rate, iters=4, dtype=dt)(
            x16.cuda()).cpu(),
        fldpc.make_decoder(plp.fec_frame, plp.rate, iters=4, dtype=dt)(x16))
        for dt in (torch.bfloat16, torch.float32)}
    got = bits.cpu().numpy().reshape(-1, fec.n_ldpc)
    ok_cw = int((got == cw).all(axis=1).sum())
    st = stats.cpu().numpy()
    want = np.array([cw.sum(), len(cw)], np.float32)
    same = torch.equal(bits, rbits) and torch.equal(stats, rstats)
    log(f"[sharded] sharded_fused_step F={SHARD_FRAMES} x {NUM_BLOCKS} "
        f"codewords, front end on, 4 f32 flooding iterations: "
        f"{ok_cw}/{len(cw)} codewords equal to the transmitted ones; stats "
        f"{st.tolist()} (transmitted {want.tolist()}); equal to the modules "
        f"with no process group: {same}; "
        f"{1e3 * np.median(times[1:]):.2f} ms per step (median of 3 after "
        f"the first, {1e3 * times[0]:.2f} ms), "
        f"{1e3 * np.median(times[1:]) / SHARD_FRAMES:.2f} ms per frame")
    log(f"[sharded] the flooding decoder on the card equals it on the CPU "
        f"(16 NORMAL C2/3 words at sigma 0.8, 4 iterations): {same_cpu}")
    if ok_cw != len(cw) or not np.array_equal(st, want) or not same \
            or not all(same_cpu.values()):
        raise RuntimeError("sharded step gate failed")

    # the v1 step, the dryrun's part 2: the per-frame v1 demod, then the
    # rank's block of the flattened codeword batch, 2 f32 flooding
    # iterations; on un-impaired frames (no front end in this step)
    body = frames[:V1_FRAMES, P1_LEN:P1_LEN + blen]
    bodies = torch.from_numpy(np.stack([body.real, body.imag], -1).astype(
        np.float32))
    del body
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        step = sharding.sharded_receive_step(p, plp, NUM_BLOCKS,
                                             sharding.make_mesh(1),
                                             ldpc_iters=2)
        t0 = time.perf_counter()
        vbits, vstats = step(bodies.cuda(), SHARD_INV_NVAR)
        torch.cuda.synchronize()
        v_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    cbits, cstats = sharding.local_receive_step(p, plp, NUM_BLOCKS, 2)(
        bodies, SHARD_INV_NVAR)
    c_s = time.perf_counter() - t0
    v_same = torch.equal(vbits.cpu(), cbits) and torch.equal(
        vstats.cpu(), cstats)
    v_cw = cw[:V1_FRAMES * NUM_BLOCKS]
    v_ok = int((vbits.cpu().numpy() == v_cw).all(axis=1).sum())
    log(f"[sharded] v1 step (dryrun part 2) F={V1_FRAMES} x {NUM_BLOCKS} "
        f"codewords, 2 f32 flooding iterations: bits equal to the same "
        f"step on the CPU: {v_same}; {v_ok}/{len(v_cw)} codewords equal to "
        f"the transmitted ones; stats {vstats.cpu().tolist()}; "
        f"{v_ms:.2f} ms on the card (first call), {c_s:.2f} s on the CPU")
    if not v_same or v_ok != len(v_cw) \
            or int(vstats[1]) != V1_FRAMES * NUM_BLOCKS:
        raise RuntimeError("v1 step gate failed")


def phase_ber():
    """The BER tool (`tools/ber_validation.ber_table`) at NORMAL C2/3,
    B=128, on the card: K3 (layered10_f32 and layered10_bf16), the bf16
    flooding decoder and K1 (layered10_bf16_rev).  Gate: wherever the
    flooding BER is at least 1e-3, each layered column is within 10%
    (relative) of it.  -> launch counts."""
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (CodeRate,
                                                            FECFrame)
    from sdr_receiver_dvb_t2_tpu_torch.tools import ber_validation as bv
    counts = _zero_counts()
    t0 = time.time()
    rows = bv.ber_table(FECFrame.NORMAL, CodeRate.C2_3, bv.BATCH,
                        bv.SIGMAS, "cuda")
    torch.cuda.synchronize()
    launches = _read_counts(counts)
    bad = []
    for row in rows:
        log(f"[ber] sigma={row['sigma']}: " + "  ".join(
            f"{k}={v:.3e}" for k, v in row.items() if k != "sigma"))
        ref = row["flood25_bf16"]
        if ref >= 1e-3:
            bad += [(row["sigma"], k) for k in row
                    if k.startswith("layered")
                    and abs(row[k] - ref) > 0.1 * ref]
    log(f"[ber] NORMAL C2/3, B={bv.BATCH}, {time.time() - t0:.1f} s; the "
        f"JAX tool (TPU, commit 7da07ec) at sigma 0.74: layered10_bf16_rev "
        f"4.98e-2, layered10_f32 4.97e-2, flood25 4.93e-2; launches "
        f"{launches}")
    if bad:
        raise RuntimeError(f"BER gate failed (sigma, decoder): {bad}")
    if launches["K1"] == 0 or launches["K3"] + launches["K4"] == 0:
        raise RuntimeError("the BER tool did not launch K1 and K3/K4")
    return launches


def phase_stream_dist():
    """Both two-process streaming mechanisms at the headline mode, two
    gloo ranks sharing cuda:0, each decoding with DeviceT2Receiver (K2);
    the single-process reference runs here once they have ended.  -> the
    ranks' launch counts, summed (each rank is a fresh process whose
    counts start at 0 and are read at its end)."""
    from sdr_receiver_dvb_t2_tpu_torch.tools import \
        concurrent_stream_bench as csb
    total = {k: 0 for k in kernel_wrappers()}
    for label, run in (("handoff", csb.run_handoff),
                       ("concurrent", csb.run_concurrent)):
        torch.cuda.empty_cache()
        t0 = time.time()
        sec = run("headline", "device", "cuda", STREAM_DIST_FRAMES)
        wall = time.time() - t0
        for r in sec["launches"].values():
            for k, v in r.items():
                total[k] += v
        pub = csb.public(sec)
        if label == "handoff":
            log(f"[stream {label}] {STREAM_DIST_FRAMES} frames: frames "
                f"decoded by rank {pub['frames_by_rank']}, TS packets "
                f"{pub['ts_packets_by_rank']}, front end "
                f"{pub['frontend']}; rank walls (s) "
                f"{ {r: round(v, 3) for r, v in pub['wall_s'].items()} }; "
                f"one process {pub['single_wall_s']:.3f} s for "
                f"{pub['single_frames']} frames; TS bit-exact="
                f"{pub['ts_bit_exact_vs_single_process']} ({len(sec['ts'])} "
                f"bytes), TS errors {pub['ts_errors']}; launches by rank "
                f"{pub['launches']}; capture {pub['capture_s']:.1f} s; "
                f"{wall:.1f} s in all")
        else:
            h = pub["cfo_history_hz"]
            log(f"[stream {label}] {STREAM_DIST_FRAMES} frames, "
                f"{pub['rounds']} rounds of 2 x {2} frames: per-round "
                f"decode walltimes (s) {pub['round_walltimes_s']}; rank "
                f"walls (s) {pub['wall_s']}; one process "
                f"{pub['single_wall_s']:.3f} s for {pub['single_frames']} "
                f"frames; CFO history {[round(c, 3) for c in h]} Hz, equal "
                f"in both ranks: {pub['cfo_history_equal']}; TS bit-exact="
                f"{pub['ts_bit_exact_vs_single_process']} ({len(sec['ts'])} "
                f"bytes), TS errors {pub['ts_errors']}; launches by rank "
                f"{pub['launches']}; capture {pub['capture_s']:.1f} s; "
                f"{wall:.1f} s in all")
            if not pub["cfo_history_equal"] or not any(
                    abs(h[i + 1] - h[i]) > 1e-3 for i in range(len(h) - 1)):
                raise RuntimeError("concurrent streaming: the shared CFO "
                                   "state did not cross or did not move")
        if not pub["ts_bit_exact_vs_single_process"] or pub["ts_errors"]:
            raise RuntimeError(f"{label} streaming: TS not bit-exact")
        if any(v["K2"] == 0 for v in pub["launches"].values()):
            raise RuntimeError(f"{label} streaming: a rank never launched "
                               "K2")
    return total


def phase_tools(p, plp):
    """The microbenches and the LDPC gate at the headline mode, each
    printing its numbers; any gate that fails raises.  -> launch counts."""
    from sdr_receiver_dvb_t2_tpu_torch.tools import (
        demod_microbench, demod_split_microbench as dsm, fec_tail_microbench,
        hbm_vmem_equivalence, ldpc_iters_sweep, ldpc_microbench,
        path_microbench)
    torch.cuda.empty_cache()
    counts = _zero_counts()
    t0 = time.time()
    split = dsm.run(p, plp, NUM_BLOCKS, SPLIT_FRAMES, reps=TOOL_REPS,
                    log=lambda m: log(m))
    for h in dsm.HEADS:
        log(f"[demod split {h}] F={SPLIT_FRAMES}, ms/frame by stage: "
            + "  ".join(f"{s} {v / SPLIT_FRAMES:.4f}"
                        for s, v in dsm.deltas(split[h]).items())
            + f"; all {split[h]['llr'] / SPLIT_FRAMES:.4f}")
    log(f"[demod split] the llr prefix equals MultiFramePath.syms: "
        f"{split['llr_equals_path']} ({split['llr_differing']} LLRs differ; "
        f"{split['llr_nan']} NaN in both, where the random symbols make a "
        f"channel estimate of 0); {time.time() - t0:.1f} s")
    if not split["llr_equals_path"]:
        raise RuntimeError("demod split: the llr prefix is not the path")
    torch.cuda.empty_cache()
    path = path_microbench.run(p, plp, NUM_BLOCKS, 8, reps=TOOL_REPS,
                               log=lambda m: log(m))
    log(f"[path] the llrs prefix equals MultiFramePath: "
        f"{path['llrs_equal_path']} ({path['llrs_differing']} LLRs differ)")
    if not path["llrs_equal_path"]:
        raise RuntimeError("path microbench: llrs prefix is not the path")
    torch.cuda.empty_cache()
    dm = demod_microbench.run(p, 32, reps=TOOL_REPS, log=lambda m: log(m))
    if not dm["div_rdiv_max_rel"] < 1e-5:
        raise RuntimeError("demod microbench: the equalizer forms differ")
    torch.cuda.empty_cache()
    fec = fec_tail_microbench.run(reps=TOOL_REPS, log=lambda m: log(m))
    log(f"[fec tail] BCH-clean codewords {fec['bch_clean']} of "
        f"{fec['codewords']}; per-frame and grouped hashes equal: "
        f"{fec['hash_equal']}")
    if not fec["hash_equal"] or any(v != fec["codewords"]
                                    for v in fec["bch_clean"].values()):
        raise RuntimeError("fec tail microbench gate failed")
    torch.cuda.empty_cache()
    lm = ldpc_microbench.run(reps=4, log=lambda m: log(m))
    if not all(v["decode_exact"] for v in lm.values()):
        raise RuntimeError("ldpc microbench: a decode was not exact")
    recs = hbm_vmem_equivalence.run(log=lambda m: log(f"[hbm/vmem] {m}"))
    if not all(r["ok"] for r in recs):
        raise RuntimeError("hbm_vmem_equivalence failed")
    ldpc_iters_sweep.run(snrs=(19.0,), log=lambda m: log(f"[iters sweep] "
                                                          f"{m}"))
    torch.cuda.synchronize()
    launches = _read_counts(counts)
    log(f"[tools] {time.time() - t0:.1f} s; launches {launches}")
    for k in ("K2", "K3", "K4", "K6"):
        if launches[k] == 0:
            raise RuntimeError(f"the tools never launched {k}")
    return launches


def gate_no_foreign_modules():
    """Neither jax nor the JAX package (`sdr_receiver_dvb_t2_tpu`, not the
    port, whose name it prefixes) may be loaded."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "sdr_receiver_dvb_t2_tpu"))
    if bad:
        raise RuntimeError(f"foreign modules were imported: {bad[:5]}")
    log("[modules] no jax module and no module of the JAX package loaded")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4,
                    help="frames per superstep (default 4)")
    ap.add_argument("--rx-frames", type=int, default=4,
                    help="frames of the receiver capture (default 4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device; this smoke test runs only on the card")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import CodeRate
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    phase_build()
    checks = phase_kernels()
    layer_us = phase_all_codes()
    # the second floor of a layered kernel, beside its roofline bound: the
    # layers of one codeword run one after another on one SM
    for k in ("K1", "K2", "K3", "K4", "K5"):
        layers = checks[k].pop("_layers")
        us = layer_us["C3_5" if k == "K4" else "C2_3"]
        log(f"[chain floor] {k}: {layers} layers x {us:.3f} us (the least "
            f"time of one layer's gather, scan, barrier and write-back) = "
            f"{layers * us / 1e3:.3f} ms; kernel {checks[k]['ms']:.3f} ms, "
            f"roofline bound {checks[k]['bound_ms']:.4f} ms")
    launches, err_slice = phase_slice(args.frames)
    p, plp = bg.headline_mode(NUM_BLOCKS)
    launches["K6"] = phase_fft_tool(FFT_FRAMES)
    rx_launches = phase_receiver(
        p, plp, dataclasses.replace(plp, rate=CodeRate.C3_5),
        args.rx_frames, "cuda")
    fe_launches = phase_stream_frontend(p, plp, "cuda")
    cli_launches = phase_cli(p, plp)
    phase_sharded(p, plp)
    ber_launches = phase_ber()
    dist_launches = phase_stream_dist()
    tool_launches = phase_tools(p, plp)
    gate_no_foreign_modules()
    names = {"K1": "ldpc_layered_vmem_adaptive_io",
             "K2": "ldpc_layered_vmem_adaptive",
             "K3": "ldpc_layered_vmem", "K4": "ldpc_layered_hbm",
             "K5": "ldpc_layered_fused_io", "K6": "fft_stage1",
             "K7": "llr_tail", "K8": "frontend_correct"}
    replaces = {"K1": f"{PALLAS}:819", "K2": f"{PALLAS}:665",
                "K3": f"{PALLAS}:1020", "K4": f"{PALLAS}:227",
                "K5": f"{PALLAS}:1137", "K6": "tools/fft_microbench.py:147",
                "K7": "none (XLA fused the JAX package's LLR tail)",
                "K8": "none (XLA fused the JAX package's slice corrector)"}
    sources = {"K6": SOURCE_K6, "K7": SOURCE_K7, "K8": SOURCE_K8}
    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"):
        rec = dict(checks[k])
        n = (launches[k] + rx_launches[k] + fe_launches[k]
             + cli_launches[k] + ber_launches[k] + dist_launches[k]
             + tool_launches[k])
        if n == 0:
            raise RuntimeError(f"{k} was never launched on a main path")
        if k in ("K1", "K5"):
            rec["max_abs_err"] = max(rec["max_abs_err"], err_slice)
        kernels.append({
            "name": f"{k} {names[k]}", "route": "cuda",
            "source": sources.get(k, SOURCE),
            "replaces": replaces[k], "launches": n, **rec})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
