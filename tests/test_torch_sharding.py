"""The port's data-parallel step (sdr_receiver_dvb_t2_tpu_torch/parallel/
sharding.py) and entry hooks (sdr_receiver_dvb_t2_tpu_torch/entry.py)
against the JAX package's `parallel/sharding.py` and the root
`__graft_entry__.py`, on the CPU with gloo process groups.

- `make_mesh`: JAX's (t, n/t) factorisation at n = 1, 2, 8 (fake groups);
- `sharded_fused_step` in a world-1 gloo group, with and without the
  front end, on modulated frames of the tiny mode: the bits and stats of
  JAX's step on a 1-device mesh (tolerance 0: both decode every codeword);
- its collectives: recorded at the dispatcher (every c10d op) over one
  step; at least one, none above 256 bytes;
- `dryrun` on two gloo ranks through `launch`, and `launch` raising when a
  rank fails;
- `entry(device="cpu")` against JAX `entry()` on the same raw input: LLRs
  within the fused path's tolerance (1e-4 of the largest LLR, equal signs
  beyond it), hard bits of the 4-iteration f32 flooding decoder agreeing
  on at least 99.99% (measured: all 518,400 equal; the random input
  leaves LLRs near 0 that the two FFTs could round to either side).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.parallel import sharding as jsh
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator
from sdr_receiver_dvb_t2_tpu_torch import entry as tentry
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as fdev
from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding as tsh
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import (
    params_from_reference as R)

from tests.test_sharding import tiny_mode

torch.set_num_threads(1)

F = 2
INV_NVAR = 1.0e3
SCO = 2e-5


@pytest.fixture
def world1():
    """A world-1 gloo process group in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 2, 8])
def test_make_mesh_shapes(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = tsh.make_mesh(n)
        ref = jsh.make_mesh(n)
        assert tuple(mesh.mesh.shape) == ref.devices.shape
        assert mesh.mesh_dim_names == ref.axis_names == ("time", "cw")
        assert mesh.size() == n
        with pytest.raises(ValueError):
            tsh.make_mesh(n + 1)
    finally:
        dist.destroy_process_group()


def _bodies(p, plp):
    """(F, len_frame*symbol_size, 2) f32 bodies of F modulated frames."""
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(11)
    ts = rng.integers(0, 256, (mod.packets_needed(F) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    s = mod.modulate(ts.reshape(-1), F).samples
    blen = p.len_frame * p.symbol_size
    body = np.stack([s[k * p.frame_samples + 2048:
                       k * p.frame_samples + 2048 + blen] for k in range(F)])
    return np.stack([body.real, body.imag], -1).astype(np.float32)


def _raw(bodies):
    """The bodies as a device clock SCO fast would sample them (int16
    grid), behind the 2*HALF pre-pad the front end eats."""
    clean = torch.nn.functional.pad(torch.from_numpy(bodies),
                                    (0, 0, 2 * tsh.HALF, 0))
    n_raw = fdev.frontend_raw_len(bodies.shape[1], SCO)
    raw = fdev.make_impairer(n_raw, 9.142857e6, half=tsh.HALF)(
        clean, 0.0, 1.0 + SCO, 0.0, torch.zeros(2),
        torch.tensor([1.0, 0.0]), None, 0.0)
    return raw.numpy()


@pytest.mark.parametrize("with_frontend", [False, True],
                         ids=["bodies", "frontend"])
def test_sharded_step_equals_jax(world1, with_frontend):
    p, plp = tiny_mode()
    x = _bodies(p, plp)
    if with_frontend:
        x = _raw(x)
    ref = jsh.sharded_fused_step(p, plp, 2, F, jsh.make_mesh(1),
                                 ldpc_iters=4, with_frontend=with_frontend)
    rb, rs = ref(jnp.asarray(x), jnp.float32(INV_NVAR))
    step = tsh.sharded_fused_step(R(p), R(plp), 2, F, tsh.make_mesh(),
                                  ldpc_iters=4, with_frontend=with_frontend)
    bits, stats = step(torch.from_numpy(x), INV_NVAR)
    assert bits.dtype == torch.uint8
    assert bits.shape == (F, 2, plp.fec.n_ldpc) == np.asarray(rb).shape
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(rs))
    assert stats[1] == F * 2


class _Collectives(TorchDispatchMode):
    """Records (op, bytes of its tensor operands) for every c10d op."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            leaves, _ = tree_flatten((args, kwargs))
            self.ops.append((str(func), sum(
                t.numel() * t.element_size() for t in leaves
                if isinstance(t, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def test_fused_step_collective_traffic_is_scalar_only(world1):
    """Frames are data-parallel, so the only traffic between ranks allowed
    is the stats all-reduce: every collective of one step moves at most
    256 bytes, against the tens of kB of samples each rank consumes per
    frame."""
    p, plp = tiny_mode()
    step = tsh.sharded_fused_step(R(p), R(plp), 2, 1, tsh.make_mesh(),
                                  ldpc_iters=2)
    bodies = torch.zeros((1, p.len_frame * p.symbol_size, 2))
    with _Collectives() as rec:
        step(bodies, 1.0)
    assert rec.ops, "expected the stats all-reduce"
    worst = max(b for _, b in rec.ops)
    assert worst <= 256, rec.ops
    assert bodies.numel() * 4 / worst > 1000


def test_dryrun_two_ranks():
    p, plp = tiny_mode()
    tsh.launch(2, tsh.dryrun, R(p), R(plp), 2, 2, device="cpu")


def test_launch_raises_when_a_rank_fails():
    """make_mesh(3) in a 2-rank group raises in both ranks."""
    with pytest.raises(Exception, match="needs a process group of 3"):
        tsh.launch(2, tsh.make_mesh, 3, device="cpu")


def test_entry_cpu_equals_jax():
    import __graft_entry__ as ge
    fn_j, (raw_j, inv_j) = ge.entry()
    fn_t, (raw_t, inv_t) = tentry.entry(device="cpu")
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
    assert inv_t == float(inv_j)
    bits_t = fn_t(raw_t, inv_t)
    bits_j = np.asarray(fn_j(raw_j, inv_j))
    assert bits_t.dtype == torch.uint8
    assert bits_t.shape == bits_j.shape == (8, 64800)
    # the LLRs: JAX's forward up to its decoder, as __graft_entry__ has it
    from sdr_receiver_dvb_t2_tpu.ops import frontend_device as jfe
    from sdr_receiver_dvb_t2_tpu.rx import fusedpath as jfp
    p, plp = ge._flagship()
    fe = jfe.make_frontend(p.len_frame * p.symbol_size, p.sample_rate,
                           chunk=16384)
    bodies, _, _ = fe(raw_j, jnp.float32(1200.0), jnp.float32(1.0 + SCO),
                      jnp.float32(8.0 * (1.0 + SCO)), jnp.float32(0.0))
    llr_j = np.asarray(jfp.get_fused_plp_path(p, plp, 8)._fn(
        jfp.get_fused_demod(p)._fn(bodies[0]), inv_j))
    llr_t = fn_t.llrs(raw_t, inv_t).numpy()
    atol = 1e-4 * np.abs(llr_j).max()
    np.testing.assert_allclose(llr_t, llr_j, rtol=0, atol=atol)
    sure = np.abs(llr_j) > atol
    np.testing.assert_array_equal(np.sign(llr_t[sure]), np.sign(llr_j[sure]))
    agree = (bits_t.numpy() == bits_j).mean()
    assert agree >= 0.9999, agree


def test_entry_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
