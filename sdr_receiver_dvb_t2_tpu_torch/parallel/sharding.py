"""Data-parallel receive step across GPUs on `torch.distributed`.

Port of `sdr_receiver_dvb_t2_tpu/parallel/sharding.py`.  T2 frames are
the data-parallel unit: each carries its own P1 and pilots, and the
per-frame estimation has already broken the reference's serial sync
feedback (`dvbt2_demodulator.cpp:182-213`), so every rank runs the whole
front end, demod, LLR and LDPC of its own frames and exchanges nothing in
steady state.  The only collective is the all-reduce of the step's two
global statistics (the JAX `psum`).

JAX builds one program over a mesh of devices and shards a global input;
here each process is one rank on one device (rank r on `cuda:r`, NCCL; or
the CPU with gloo) and passes its own shard.  `launch` starts the ranks.

Not ported: `sharded_receive_step` and part 2 of `dryrun`, the v1 reshard
step over `rx/jaxdemod.py`, which the port does not need (ROADMAP, "Not
ported").
"""
from __future__ import annotations

import contextlib
import math
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..dvbt2.params import PLPParams, T2Params
from ..ops import ldpc as fldpc

HALF = 8              # the front end's Farrow stencil half-width


def make_mesh(n_devices: int | None = None, axis_names=("time", "cw")):
    """(t, n/t) `DeviceMesh` over the initialised process group, `time`
    outer and `cw` inner, t the largest divisor of n at most sqrt(n) (JAX's
    factorisation, which favours a 2-D split).  The ranks are the devices,
    so n must be the group's world size."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a process group of "
                         f"{n} ranks, not {world}")
    t = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (t, n // t),
                            mesh_dim_names=tuple(axis_names))


def local_fused_step(p: T2Params, plp: PLPParams, num_blocks: int,
                     frames_per_device: int, ldpc_iters: int = 4,
                     with_frontend: bool = False, sco: float = 2e-5):
    """One rank's part of `sharded_fused_step`, with no collective:
    fn(bodies, inv_nvar) -> (bits (F, nb, n_ldpc) uint8, this rank's stats
    (2,) f32 [ones, codewords])."""
    from ..rx import fusedpath

    mf = fusedpath.MultiFramePath(p, plp, num_blocks, frames_per_device)
    decode = fldpc.make_decoder(plp.fec_frame, plp.rate, iters=ldpc_iters,
                                dtype=torch.float32)
    fe = None
    if with_frontend:
        # the bench's head: the symbol-emitting front end (DC/IQ, NCO,
        # Farrow at the post-guard grid of a frame with no P1) feeding the
        # demod's class-ordered symbol entry
        from ..ops import frontend_device as fdev
        ratio = 1.0 + sco
        fe = fdev.make_frontend_symbols(p.len_frame, p.symbol_size,
                                        p.guard_size, p.sample_rate,
                                        p1_len=0, half=HALF,
                                        sym_order=mf.demod.sym_order,
                                        out_dtype=torch.bfloat16)
        fe_args = (0.0, ratio, HALF * ratio, 0.0)

    def step(bodies: torch.Tensor, inv_nvar):
        if fe is not None:
            (sr, si), _, _ = fe(bodies[..., 0], bodies[..., 1], *fe_args)
            llrs = mf.syms(sr, si, inv_nvar)
        else:
            llrs = mf(bodies, inv_nvar)                 # (N, nb, F)
        lf = llrs.permute(2, 1, 0)                      # (F, nb, N)
        f, nb, n = lf.shape
        bits = decode(lf.reshape(f * nb, n).float())
        # the count of ones in int64, then f32: exact where JAX's f32 sum
        # is, and rounded once beyond 2^24
        stats = torch.stack([
            bits.sum(dtype=torch.int64).to(torch.float32),
            torch.full((), f * nb, dtype=torch.float32,
                       device=bits.device)])
        return bits.reshape(f, nb, n), stats

    return step


def sharded_fused_step(p: T2Params, plp: PLPParams, num_blocks: int,
                       frames_per_device: int, mesh, ldpc_iters: int = 4,
                       with_frontend: bool = False, sco: float = 2e-5):
    """The multi-GPU step over the production fused path
    (`rx/fusedpath.MultiFramePath`, the pipeline the bench measures), then
    the f32 flooding decoder, as JAX's (`sharding.py:130`).

    fn(bodies (F, len_frame*symbol_size, 2) f32 on this rank's device,
       inv_nvar) -> (bits (F, nb, n_ldpc) uint8,
                     stats (2,) f32 [total ones, total codewords] over the
                     mesh: one all-reduce, the step's only collective)

    with_frontend=True prepends the device front end (DC/IQ estimate and
    correction, NCO, Farrow resampling from a device clock `sco` off): the
    input becomes raw device-rate samples (F, n_raw, 2) with
    n_raw = frontend_raw_len(len_frame*symbol_size, sco).  The mesh spans
    the whole process group (`make_mesh`)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the process group")
    local = local_fused_step(p, plp, num_blocks, frames_per_device,
                             ldpc_iters, with_frontend, sco)

    def step(bodies: torch.Tensor, inv_nvar):
        bits, stats = local(bodies, inv_nvar)
        dist.all_reduce(stats, op=dist.ReduceOp.SUM)
        return bits, stats

    return step


def rank_device(mesh) -> torch.device:
    """This rank's device: the current CUDA device on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def dryrun(p: T2Params, plp: PLPParams, num_blocks: int,
           n_devices: int) -> None:
    """Run one sharded step on tiny shapes, on every rank of an
    initialised group of n_devices ranks (the entry hook; `launch` starts
    the ranks).  Part 1: the fused path on bodies, one frame per rank;
    part 1b: the same from raw device-rate samples through the front end.
    Shapes and the global codeword count are checked as in JAX.  Part 2 of
    the JAX dryrun, the v1 reshard step over `rx/jaxdemod.py`, is not
    ported: the port does not need that module (ROADMAP, "Not ported")."""
    from ..ops.frontend_device import frontend_raw_len

    mesh = make_mesh(n_devices)
    total, rank, dev = mesh.size(), dist.get_rank(), rank_device(mesh)
    rng = np.random.default_rng(0)
    want = (1, num_blocks, plp.fec.n_ldpc)

    fstep = sharded_fused_step(p, plp, num_blocks, frames_per_device=1,
                               mesh=mesh, ldpc_iters=2)
    bodies = rng.normal(size=(total, p.len_frame * p.symbol_size, 2)
                        ).astype(np.float32)
    fbits, fstats = fstep(torch.from_numpy(bodies[rank:rank + 1]).to(dev),
                          1.0)
    _check(tuple(fbits.shape) == want, f"bits {tuple(fbits.shape)}")
    _check(int(fstats[1]) == total * num_blocks, f"stats {fstats.tolist()}")

    rstep = sharded_fused_step(p, plp, num_blocks, frames_per_device=1,
                               mesh=mesh, ldpc_iters=2, with_frontend=True)
    n_raw = frontend_raw_len(p.len_frame * p.symbol_size, 2e-5)
    raw = rng.normal(size=(total, n_raw, 2)).astype(np.float32)
    rbits, rstats = rstep(torch.from_numpy(raw[rank:rank + 1]).to(dev), 1.0)
    _check(tuple(rbits.shape) == want, f"bits {tuple(rbits.shape)}")
    _check(int(rstats[1]) == total * num_blocks, f"stats {rstats.tolist()}")


def free_addr() -> str:
    """'localhost:<port>' of a free local port, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


@contextlib.contextmanager
def rank_group(rank: int, world: int, addr: str, device_type: str):
    """Join the process group of `world` ranks at tcp://addr as `rank`:
    NCCL on cuda:rank (set before the group is built), or gloo on the
    CPU.  The group is destroyed on leaving, also on an error."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}", rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, n, addr, device_type, fn, args):
    with rank_group(rank, n, addr, device_type):
        fn(*args)


def launch(n: int, fn, *args, device="cuda") -> None:
    """Run fn(*args) on n ranks, each a process started by
    torch.multiprocessing "spawn" (fn is pickled by its import path, and
    each rank imports the caller's main module: a script that calls this
    keeps its own work under `if __name__ == "__main__":`).  On the card
    rank r runs on cuda:r with NCCL; device="cpu" gives gloo ranks on the
    CPU.  The group is built over a free local port and destroyed in every
    rank.  A rank that fails makes this raise (torch.multiprocessing stops
    the others)."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on the card need {n} CUDA devices, "
                           f"found {torch.cuda.device_count()}")
    mp.start_processes(_rank_main,
                       args=(n, free_addr(), device_type, fn, args),
                       nprocs=n, join=True, start_method="spawn")
