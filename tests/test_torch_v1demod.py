"""The port's v1 demod (sdr_receiver_dvb_t2_tpu_torch/rx/jaxdemod.py) and
v1 sharded step (`parallel/sharding.sharded_receive_step`, part 2 of
`dryrun`) against the JAX package's, on the CPU.

- `FrameDemod` on an 8K frame (`tests/test_jax_path.py`'s loopback):
  cells within 1e-4 of JAX's (both FFTs in f32; the cells are O(1));
- `PLPDecodePath` on those cells: LLRs within 1e-4 of the largest LLR,
  hard decisions equal;
- `sharded_receive_step` on modulated frames of the tiny mode: at world 1
  (gloo) and on two gloo ranks, the bits equal JAX's step on a 1-device
  mesh, tolerance 0 (every codeword decodes in both); stats equal;
- the reshard moves nothing: each rank's block of the flattened batch is
  a slice of its own time shard (the mesh rule, for n = 1..16);
- `dryrun` runs its three parts.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.parallel import sharding as jsh
from sdr_receiver_dvb_t2_tpu.rx import jaxdemod as jd
from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding as tsh
from sdr_receiver_dvb_t2_tpu_torch.rx import jaxdemod as td
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import (
    params_from_reference as R)

from tests.test_jax_path import _loopback_setup
from tests.test_sharding import tiny_mode
from tests.test_torch_sharding import _bodies

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loopback():
    p, plp, out = _loopback_setup()
    body = out.samples[2048:2048 + p.len_frame * p.symbol_size].astype(
        np.complex64)
    return p, plp, out, body


def test_frame_demod_equals_jax(loopback):
    p, _, _, body = loopback
    ref = np.asarray(jd.FrameDemod(p)(body))
    got = td.FrameDemod(R(p))(body, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_plp_path_equals_jax(loopback):
    p, plp, out, body = loopback
    cells = np.asarray(jd.FrameDemod(p)(body))
    l1_cells = 1840 + out.l1pre.l1_post_size
    sl = cells[l1_cells:l1_cells + 3 * plp.cells_per_fec_block]
    ref = np.asarray(jd.PLPDecodePath(plp, 3)(sl, np.float32(1e3)))
    got = td.PLPDecodePath(R(plp), 3)(sl, 1e3, device="cpu").numpy()
    assert got.shape == ref.shape == (3, plp.fec.n_ldpc)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale)
    np.testing.assert_array_equal(got < 0, ref < 0)


def _jax_v1(p, plp, bodies):
    step = jsh.sharded_receive_step(p, plp, 2, jsh.make_mesh(1),
                                    ldpc_iters=2)
    bits, stats = step(jnp.asarray(bodies), jnp.float32(1.0e3))
    return np.asarray(bits), np.asarray(stats)


def test_sharded_receive_step_world1_equals_jax():
    p, plp = tiny_mode()
    bodies = _bodies(p, plp)
    jbits, jstats = _jax_v1(p, plp, bodies)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        step = tsh.sharded_receive_step(R(p), R(plp), 2, tsh.make_mesh(1),
                                        ldpc_iters=2)
        bits, stats = step(torch.from_numpy(bodies), 1.0e3)
    finally:
        dist.destroy_process_group()
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(stats.numpy(), jstats)


def _v1_rank(p, plp, bodies, out_dir):
    """One gloo rank of the v1 step: its time shard in, its block out."""
    mesh = tsh.make_mesh()
    t, _ = mesh.shape
    i, _ = mesh.get_coordinate()
    per = bodies.shape[0] // t
    bits, stats = tsh.sharded_receive_step(p, plp, 2, mesh, ldpc_iters=2)(
        torch.from_numpy(bodies[i * per:(i + 1) * per]), 1.0e3)
    rank = dist.get_rank()
    np.save(f"{out_dir}/bits{rank}.npy", bits.numpy())
    with open(f"{out_dir}/stats{rank}.json", "w") as f:
        json.dump(stats.tolist(), f)


def test_sharded_receive_step_two_ranks_equals_jax(tmp_path):
    """Two gloo ranks, mesh (1, 2): rank j decodes block j of the flattened
    batch; the blocks in rank order are JAX's bits."""
    p, plp = tiny_mode()
    bodies = _bodies(p, plp)
    jbits, jstats = _jax_v1(p, plp, bodies)
    tsh.launch(2, _v1_rank, R(p), R(plp), bodies, str(tmp_path),
               device="cpu")
    got = np.concatenate([np.load(tmp_path / f"bits{r}.npy")
                          for r in range(2)])
    np.testing.assert_array_equal(got, jbits)
    for r in range(2):
        stats = json.loads((tmp_path / f"stats{r}.json").read_text())
        np.testing.assert_array_equal(np.float32(stats), jstats)


@pytest.mark.parametrize("n", range(1, 17))
def test_reshard_block_lies_in_its_time_shard(n):
    """JAX's P(("time", "cw")) block of rank (i, j) lies inside time shard
    i of the flattened batch, for the mesh make_mesh gives at n devices
    and any whole number of codewords per block."""
    t = next(c for c in range(int(np.sqrt(n)), 0, -1) if n % c == 0)
    c = n // t
    for rows in (1, 3):
        total = n * rows                       # codewords in the batch
        for i in range(t):
            shard = range(i * total // t, (i + 1) * total // t)
            for j in range(c):
                blk = range((i * c + j) * rows, (i * c + j + 1) * rows)
                assert blk[0] in shard and blk[-1] in shard
                # and it is block j of the shard's own rows
                assert blk[0] - shard[0] == j * rows


def test_dryrun_runs_three_parts(monkeypatch):
    """dryrun at world 1 runs the fused step twice (bodies, raw samples)
    and the v1 step once."""
    calls = []
    fused, v1 = tsh.sharded_fused_step, tsh.sharded_receive_step
    monkeypatch.setattr(tsh, "sharded_fused_step", lambda *a, **k: (
        calls.append("fused"), fused(*a, **k))[1])
    monkeypatch.setattr(tsh, "sharded_receive_step", lambda *a, **k: (
        calls.append("v1"), v1(*a, **k))[1])
    p, plp = tiny_mode()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        tsh.dryrun(R(p), R(plp), 2, 1)
    finally:
        dist.destroy_process_group()
    assert calls == ["fused", "fused", "v1"]
