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
the CPU with gloo) and passes its own shard.  `launch` starts the ranks;
`launch(..., backend="gloo")` gives ranks on the card a gloo group, for
work whose exchanges are host bytes (`parallel/streaming.py`): NCCL takes
one card per rank, gloo lets several ranks share one.

The v1 step `sharded_receive_step` (part 2 of `dryrun`) demods each
frame through `rx/jaxdemod.py` and decodes the flattened codeword batch
resharded over the whole (time, cw) mesh.  In JAX that reshard moves
nothing: the LLRs are sharded over `time` and replicated over `cw`, and
device (i, j)'s block of the flattened batch under P(("time", "cw")),
rows (i*c + j) * R .. (i*c + j + 1) * R with R = F*nb / (t*c), lies
inside its own time shard i, rows i*c*R .. (i + 1)*c*R.  So each rank
here takes that block out of its own shard's LLRs: a local slice, and
the step's only collective is again the all-reduce of its two stats.
"""
from __future__ import annotations

import contextlib
import math
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..dvbt2 import l1 as l1mod
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


def local_receive_step(p: T2Params, plp: PLPParams, num_blocks: int,
                       ldpc_iters: int = 8, part: int = 0, parts: int = 1):
    """One rank's part of `sharded_receive_step`, with no collective:
    fn(bodies (F, len_frame*symbol_size, 2) f32, inv_nvar) -> (bits
    (F*nb/parts, n_ldpc) uint8: block `part` of the flattened codeword
    batch, this rank's stats (2,) f32 [ones, codewords]).  Each frame goes
    through the v1 demod (`rx/jaxdemod.py`): frame cells, the PLP's slice
    after the L1 cells, its LLRs; then the f32 flooding decoder, as in
    JAX (`sharding.py:60`)."""
    from ..rx import jaxdemod

    fd = jaxdemod.get_frame_demod(p)
    path = jaxdemod.get_plp_path(plp, num_blocks)
    decode = fldpc.make_decoder(plp.fec_frame, plp.rate, iters=ldpc_iters,
                                dtype=torch.float32)
    # the PLP slice begins right after the mode's L1 cells
    pre, _ = l1mod.build_l1(p, [plp])
    l1_cells = l1mod.L1_PRE_CELLS + pre.l1_post_size
    n_cells = num_blocks * plp.cells_per_fec_block

    def step(bodies: torch.Tensor, inv_nvar):
        llrs = torch.stack([
            path.fn(fd.fn(b)[l1_cells:l1_cells + n_cells], inv_nvar)
            for b in bodies])                            # (F, nb, N)
        cw = llrs.reshape(-1, llrs.shape[-1])
        if cw.shape[0] % parts:
            raise ValueError(f"{cw.shape[0]} codewords do not split into "
                             f"{parts} equal blocks")
        rows = cw.shape[0] // parts
        bits = decode(cw[part * rows:(part + 1) * rows])
        stats = torch.stack([
            bits.sum(dtype=torch.int64).to(torch.float32),
            torch.full((), rows, dtype=torch.float32, device=bits.device)])
        return bits, stats

    return step


def sharded_receive_step(p: T2Params, plp: PLPParams, num_blocks: int,
                         mesh, ldpc_iters: int = 8):
    """The v1 multi-GPU receive step (JAX `sharded_receive_step`).

    fn(bodies (F/t, len_frame*symbol_size, 2) f32: this rank's time
       shard, the frames of its mesh row i (every rank of the row passes
       the same frames, as JAX replicates them over `cw`), inv_nvar)
      -> (bits (F*nb/(t*c), n_ldpc) uint8: the rank's block (i*c + j) of
          the flattened codeword batch, JAX's P(("time", "cw")) sharding,
          stats (2,) f32 [total ones, total codewords] over the mesh: one
          all-reduce, the step's only collective)

    The reshard is a local slice (this module's docstring says why)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the process group")
    _, c = mesh.shape
    _, j = mesh.get_coordinate()
    local = local_receive_step(p, plp, num_blocks, ldpc_iters, part=j,
                               parts=c)

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
    part 1b: the same from raw device-rate samples through the front end;
    part 2: the v1 step (`sharded_receive_step`, the per-frame demod of
    `rx/jaxdemod.py`): each rank decodes its block of the flattened
    codeword batch as a local slice of its time shard, and the stats make
    one all-reduce.  Shapes and the global codeword count are checked as
    in JAX."""
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

    # 2. the v1 step: each rank decodes its block of the flattened batch
    step = sharded_receive_step(p, plp, num_blocks, mesh, ldpc_iters=2)
    t, _ = mesh.shape
    i, _ = mesh.get_coordinate()
    per_row = total // t
    bits, stats = step(torch.from_numpy(
        bodies[i * per_row:(i + 1) * per_row]).to(dev), 1.0)
    _check(tuple(bits.shape) == (num_blocks, plp.fec.n_ldpc),
           f"v1 bits {tuple(bits.shape)}")
    _check(int(stats[1]) == total * num_blocks, f"v1 stats {stats.tolist()}")


def free_addr() -> str:
    """'localhost:<port>' of a free local port, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def default_backend(device_type: str) -> str:
    """NCCL for ranks on the card, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


@contextlib.contextmanager
def rank_group(rank: int, world: int, addr: str, device_type: str,
               backend: str | None = None):
    """Join the process group of `world` ranks at tcp://addr as `rank`,
    over `backend` (default: `default_backend(device_type)`).  On the card
    the rank's current device is cuda:rank with NCCL (set before the group
    is built: one card per rank) and cuda:(rank mod the card count) with
    gloo, whose exchanges are host tensors, so ranks may share a card.
    The group is destroyed on leaving, also on an error."""
    backend = backend or default_backend(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl"
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, n, addr, device_type, backend, fn, args):
    with rank_group(rank, n, addr, device_type, backend):
        fn(*args)


def launch(n: int, fn, *args, device="cuda", backend=None) -> None:
    """Run fn(*args) on n ranks, each a process started by
    torch.multiprocessing "spawn" (fn is pickled by its import path, and
    each rank imports the caller's main module: a script that calls this
    keeps its own work under `if __name__ == "__main__":`).  On the card
    rank r runs on cuda:r with NCCL; backend="gloo" lets the ranks share
    the cards, rank r on cuda:(r mod the card count) (`rank_group`);
    device="cpu" gives gloo ranks on the CPU.  The group is built over a
    free local port and destroyed in every rank.  A rank that fails makes
    this raise (torch.multiprocessing stops the others)."""
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if have == 0 or (backend == "nccl" and have < n):
            raise RuntimeError(f"{n} {backend} ranks on the card need "
                               f"{n if backend == 'nccl' else 1} CUDA "
                               f"devices, found {have}")
    mp.start_processes(
        _rank_main, args=(n, free_addr(), device_type, backend, fn, args),
        nprocs=n, join=True, start_method="spawn")
