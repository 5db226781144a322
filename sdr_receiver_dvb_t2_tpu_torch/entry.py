"""Entry hooks of the port: the counterpart of the repository's root
`__graft_entry__.py`, which stays the JAX package's.

entry(device): the flagship forward step of the receive pipeline on one
device -- raw device-rate samples through the front end (DC/IQ, NCO,
generalized-Farrow resampling), the fused demod, the 256QAM PLP LLRs and
the f32 flooding decoder.

dryrun_multichip(n, device): n ranks (`parallel.sharding.launch`) run the
sharded step on the tiny mode and at the flagship bench shape.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve
from .dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)

SCO = 2e-5


def _flagship():
    p = T2Params(fft_mode=FFTMode.FFT_32K, guard=GuardInterval.GI_1_128,
                 pilot_pattern=PilotPattern.PP7, extended_carrier=True,
                 n_data=7)
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.NORMAL, num_blocks_max=8,
                    time_il_length=1)
    return p, plp


class Forward:
    """fn(raw2 (1, n_raw, 2) f32, inv_nvar) -> (num_blocks, n_ldpc) uint8
    hard bits; `llrs` is its first half, -> (n_ldpc, num_blocks) f32."""

    def __init__(self, p: T2Params, plp: PLPParams, num_blocks: int):
        from .ops import frontend_device as fdev
        from .ops import ldpc as fldpc
        from .rx import fusedpath
        self.fd = fusedpath.get_fused_demod(p)
        self.path = fusedpath.get_fused_plp_path(p, plp, num_blocks)
        self.decode = fldpc.make_decoder(plp.fec_frame, plp.rate, iters=4,
                                         dtype=torch.float32)
        self.fe = fdev.make_frontend(p.len_frame * p.symbol_size,
                                     p.sample_rate, chunk=16384)

    def llrs(self, raw2: torch.Tensor, inv_nvar) -> torch.Tensor:
        bodies, _, _ = self.fe(raw2, 1200.0, 1.0 + SCO, 8.0 * (1.0 + SCO),
                               0.0)
        return self.path(self.fd(bodies[0]), inv_nvar)

    def __call__(self, raw2: torch.Tensor, inv_nvar) -> torch.Tensor:
        return self.decode(self.llrs(raw2, inv_nvar).T)


def entry(device="cuda"):
    """-> (fn, example_args): the single-device forward step at the
    flagship mode (32K PP7 extended, 7 data symbols, 256QAM C2/3 NORMAL,
    8 blocks) and a seeded raw input on `device`."""
    from .ops.frontend_device import frontend_raw_len
    dev = resolve(device, "entry()")
    p, plp = _flagship()
    fn = Forward(p, plp, num_blocks=8)
    rng = np.random.default_rng(0)
    raw2 = rng.normal(size=(1, frontend_raw_len(p.len_frame * p.symbol_size,
                                                SCO), 2)).astype(np.float32)
    return fn, (torch.from_numpy(raw2).to(dev), 1.0)


def _dryrun_rank(n_devices: int) -> None:
    """One rank of `dryrun_multichip`."""
    from .ops.frontend_device import frontend_raw_len
    from .parallel import sharding

    # 1. tiny shapes: 1K FFT, SHORT FEC
    p = T2Params(fft_mode=FFTMode.FFT_1K, guard=GuardInterval.GI_1_16,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=20)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=2,
                    time_il_length=1)
    sharding.dryrun(p, plp, num_blocks=2, n_devices=n_devices)

    # 2. the flagship bench shape: 32K PP7 extended, 256QAM C2/3 NORMAL,
    # B=128 codewords, raw samples through the front end
    pf = T2Params(fft_mode=FFTMode.FFT_32K, guard=GuardInterval.GI_1_128,
                  pilot_pattern=PilotPattern.PP7, extended_carrier=True,
                  n_data=59)
    plpf = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                     fec_frame=FECFrame.NORMAL, num_blocks_max=128,
                     time_il_length=1)
    mesh = sharding.make_mesh(n_devices)
    total = mesh.size()
    rank = torch.distributed.get_rank()
    step = sharding.sharded_fused_step(pf, plpf, 128, frames_per_device=1,
                                       mesh=mesh, ldpc_iters=1,
                                       with_frontend=True)
    n_raw = frontend_raw_len(pf.len_frame * pf.symbol_size, SCO)
    raw = np.random.default_rng(0).normal(size=(total, n_raw, 2)
                                          ).astype(np.float32)
    bits, stats = step(torch.from_numpy(raw[rank:rank + 1]).to(
        sharding.rank_device(mesh)), 1.0)
    if tuple(bits.shape) != (1, 128, plpf.fec.n_ldpc):
        raise RuntimeError(f"flagship dryrun: bits {tuple(bits.shape)}")
    if int(stats[1]) != total * 128:
        raise RuntimeError(f"flagship dryrun: stats {stats.tolist()}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded step on n ranks (NCCL on the card, gloo with
    device="cpu"): `parallel.sharding.dryrun` on the tiny mode (1K,
    SHORT 16QAM, 2 blocks), then the flagship bench shape (32K PP7
    extended, 59 data symbols, 256QAM C2/3 NORMAL, B=128, front end on,
    one LDPC iteration)."""
    from .parallel.sharding import launch
    launch(n_devices, _dryrun_rank, n_devices, device=device)
