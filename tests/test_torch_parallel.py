"""The port's mesh of lanes (arbius_tpu_torch/parallel/: mesh, sharding,
collectives, distributed), ring and Ulysses attention (ops/ring.py,
ops/ulysses.py) and `quantized_dot`, against their JAX twins on the CPU.

The reference's functions run jitted under `jax.shard_map` on the 8
virtual CPU devices tests/conftest.py gives JAX; their lane twins run on
8 virtual CPU lanes (`set_virtual_lanes`), on the same numpy inputs made
from a seed. Gathers, ring passes, halo exchanges and the quantized ring
allreduce are exact; the attentions agree within 1e-5 in float32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from arbius_tpu.ops.ring import ring_attention as ref_ring
from arbius_tpu.ops.ulysses import ulysses_attention as ref_ulysses
from arbius_tpu.parallel import MeshSpec as RefMeshSpec
from arbius_tpu.parallel import build_mesh as ref_build_mesh
from arbius_tpu.parallel import collectives as ref_coll
from arbius_tpu.quant.core import quantized_dot as ref_quantized_dot
from arbius_tpu_torch import parallel
from arbius_tpu_torch.ops.ring import ring_attention, sp_attention_reference
from arbius_tpu_torch.ops.ulysses import ulysses_attention
from arbius_tpu_torch.parallel import collectives as coll
from arbius_tpu_torch.parallel import distributed
from arbius_tpu_torch.quant.core import quantized_dot


@pytest.fixture(autouse=True)
def eight_lanes(one_torch_thread):
    with parallel.virtual_lanes(8, "cpu"):
        yield


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_lanes(fn, arrays, n, axis):
    """`fn` jitted under shard_map over an sp mesh of n devices (the
    program the reference runs), each array's lanes concatenated on
    `axis` as the global input; the output split back into n lanes on
    the same axis."""
    mesh = ref_build_mesh(RefMeshSpec(dp=1, sp=n),
                          devices=jax.devices()[:n])
    spec = P(*([None] * axis + ["sp"]))
    glob = [np.concatenate(lanes, axis=axis) for lanes in arrays]
    run = jax.jit(jax.shard_map(fn, mesh=mesh,
                                in_specs=(spec,) * len(glob),
                                out_specs=spec, check_vma=False))
    return np.split(np.asarray(run(*glob)), n, axis=axis)


def _lanes(rng, n, shape, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _torch(lanes):
    return [torch.from_numpy(x.copy()) for x in lanes]


# -- mesh ---------------------------------------------------------------------

def test_lanes_are_explicit():
    """Without a virtual lane count the CPU is one lane and CUDA lanes
    are the host's cards; the count is the caller's choice, never a
    fallback."""
    assert len(parallel.lane_devices()) == 8
    with parallel.virtual_lanes(2, "cpu"):
        assert parallel.lane_devices() == [torch.device("cpu")] * 2
    parallel.set_virtual_lanes(None)
    try:
        assert parallel.lane_devices("cpu") == [torch.device("cpu")]
        assert len(parallel.lane_devices("cuda")) == \
            torch.cuda.device_count()
    finally:
        parallel.set_virtual_lanes(8, "cpu")


def test_meshspec_resolve_matches_reference():
    from arbius_tpu.parallel import MeshSpec as Ref

    for kw in ({}, {"dp": -1, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2},
               {"pp": 2, "dp": -1}):
        assert parallel.MeshSpec(**kw).resolve(8) == Ref(**kw).resolve(8)
    for kw, n in (({"dp": 3, "tp": 2}, 8), ({"dp": -1, "tp": 3}, 8)):
        with pytest.raises(ValueError):
            parallel.MeshSpec(**kw).resolve(n)


def test_mesh_lane_order_is_the_reference_device_order():
    """Lane l sits where device l sits in the reference's mesh over an
    explicit device list (row-major over pp, dp, sp, tp), so a lane's
    coordinates are its device's."""
    mesh = parallel.build_mesh(parallel.MeshSpec(dp=2, sp=2, tp=2))
    ref = ref_build_mesh(RefMeshSpec(dp=2, sp=2, tp=2),
                         devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for lane in range(8):
        c = mesh.coords(lane)
        assert ids[c["pp"], c["dp"], c["sp"], c["tp"]] == lane
    assert mesh.groups("sp") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert parallel.local_mesh(4).shape == {"pp": 1, "dp": 4, "sp": 1,
                                            "tp": 1}
    with pytest.raises(ValueError, match="asked for 9 devices, have 8"):
        parallel.local_mesh(9)


def test_batch_sharding_places_and_gathers():
    mesh = parallel.build_mesh(parallel.MeshSpec(dp=8))
    x = torch.arange(16.0).reshape(16, 1)
    xs = parallel.batch_sharding(mesh, 2).place(x)
    assert [s.shape for s in xs.shards] == [(2, 1)] * 8
    assert torch.equal(xs.shards[3], x[6:8])
    assert torch.equal(xs.gather(), x)


def test_shard_params_rules_first_match_and_indivisible():
    mesh = parallel.build_mesh(parallel.MeshSpec(dp=4, tp=2))
    rules = ((r".*to_q\.weight$", ("tp", None)),
             (r".*to_q.*", (None, "tp")),
             (r".*to_out\.weight$", (None, "tp")))
    params = {"blk.to_q.weight": torch.ones(16, 8),
              "blk.to_out.weight": torch.ones(8, 3),
              "other.weight": torch.ones(3, 3),
              "q": {"qs": torch.ones(16), "qv": torch.ones(8, 16)}}
    out = parallel.shard_params(
        params, mesh, rules + ((r"^q$", (None, "tp")),))
    assert out["blk.to_q.weight"].sharding.spec == ("tp", None)
    assert out["blk.to_q.weight"].shards[1].shape == (8, 8)
    # 3 % 2: the rule does not fit, so the leaf is replicated
    assert out["blk.to_out.weight"].sharding.spec == ()
    assert out["other.weight"].sharding.spec == ()
    # a quantized leaf: qv follows the rule, qs its last entry
    assert out["q"]["qv"].sharding.spec == (None, "tp")
    assert out["q"]["qs"].sharding.spec == ("tp",)
    # replicated lanes on one device share the tensor's storage
    assert out["other.weight"].shards[5].data_ptr() == \
        params["other.weight"].data_ptr()


# -- collectives against the reference under shard_map ----------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_gather_seq_exact(n):
    rng = np.random.default_rng(n)
    xs = _lanes(rng, n, (3, 5))
    got = coll.all_gather_seq(_torch(xs), "sp", axis=1)
    want = _ref_lanes(lambda a: ref_coll.all_gather_seq(a, "sp", axis=1),
                      [xs], n, axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.reshape(3, 5 * n))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_pass_exact(n, reverse):
    rng = np.random.default_rng(10 + n)
    xs = _lanes(rng, n, (2, 3))
    got = coll.ring_pass(_torch(xs), "sp", reverse=reverse)
    want = _ref_lanes(lambda a: ref_coll.ring_pass(a, "sp", reverse=reverse),
                      [xs], n, axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("halo", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_exact(n, halo):
    rng = np.random.default_rng(20 + n)
    xs = _lanes(rng, n, (3, 2))
    got = coll.halo_exchange(_torch(xs), "sp", axis=0, halo=halo)
    want = _ref_lanes(lambda a: ref_coll.halo_exchange(
        a, "sp", axis=0, halo=halo), [xs], n, axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_halo_exchange_rejects_oversize_halo():
    xs = [torch.zeros(1, 1) for _ in range(4)]
    with pytest.raises(ValueError, match="halo 2 exceeds per-shard extent"):
        coll.halo_exchange(xs, "sp", axis=0, halo=2)


@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_and_psum_exact(n):
    rng = np.random.default_rng(30 + n)
    xs = _lanes(rng, n, (2, 4, 3))
    got = coll.all_to_all(_torch(xs), "sp", split_axis=1, concat_axis=2)
    want = _ref_lanes(lambda a: jax.lax.all_to_all(
        a, "sp", split_axis=1, concat_axis=2, tiled=True), [xs], n, axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    ints = [rng.integers(-1000, 1000, (4,), dtype=np.int32)
            for _ in range(n)]
    sums = coll.psum([torch.from_numpy(a) for a in ints], "sp")
    for s in sums:
        np.testing.assert_array_equal(s.numpy(), np.sum(ints, axis=0))


def test_collectives_run_within_each_group_of_a_mesh():
    """With a mesh, a collective over one axis runs in every group of
    lanes that differ only along it (here sp on a dp2·sp2·tp2 mesh),
    like the reference's named-axis collectives."""
    mesh = parallel.build_mesh(parallel.MeshSpec(dp=2, sp=2, tp=2))
    xs = [torch.full((1,), float(lane)) for lane in range(8)]
    got = coll.all_gather_seq(xs, "sp", axis=0, mesh=mesh)
    for group in mesh.groups("sp"):
        for lane in group:
            assert got[lane].tolist() == [float(g) for g in group]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 4])
def test_quantized_ring_allreduce_exact_and_replicas_identical(n, mode):
    """The reference's schedule on the lanes: every replica bit-equal to
    the reference's (flattened size 35, padded to a multiple of n) and to
    the others, within the error model of the plain sum."""
    rng = np.random.default_rng(40 + n)
    xs = [x * (1 + i) for i, x in enumerate(_lanes(rng, n, (5, 7)))]
    got = coll.quantized_ring_allreduce(_torch(xs), "sp", mode=mode)
    want = _ref_lanes(lambda a: ref_coll.quantized_ring_allreduce(
        a[0], "sp", mode=mode)[None], [[x[None] for x in xs]], n, axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[0])
        assert torch.equal(g, got[0])
    total = np.sum(xs, axis=0)
    bound = 127.0 if mode == "int8" else 8.0   # int8 steps, fp8 mantissa
    err = np.abs(got[0].numpy() - total).max()
    assert err <= 2 * n * np.abs(xs).sum(axis=0).max() / bound


def test_quantized_ring_allreduce_bf16_is_psum():
    xs = [torch.tensor([1.5, -2.0]), torch.tensor([0.25, 4.0])]
    for y in coll.quantized_ring_allreduce(xs, "sp", mode="bf16"):
        assert y.tolist() == [1.75, 2.0]


# -- ring and Ulysses attention -------------------------------------------------

@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sequence_parallel_attention_matches_reference(sp, strategy):
    """[B, H, S, D] = [2, 4, 8 * sp, 8] float32, the sequence over sp
    lanes: the lane twin within 1e-5 of the reference under shard_map,
    and of single-lane attention."""
    rng = np.random.default_rng(50 + sp)
    qkv = [_lanes(rng, sp, (2, 4, 8, 8)) for _ in range(3)]
    fn, ref = {"ring": (ring_attention, ref_ring),
               "ulysses": (ulysses_attention, ref_ulysses)}[strategy]
    got = fn(*(_torch(x) for x in qkv), axis_name="sp")
    want = _ref_lanes(lambda q, k, v: ref(q, k, v, axis_name="sp"),
                      qkv, sp, axis=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    full = sp_attention_reference(
        *(torch.from_numpy(np.concatenate(x, axis=2)) for x in qkv))
    np.testing.assert_allclose(torch.cat(got, dim=2).numpy(), full.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_ulysses_needs_heads_divisible_by_sp():
    xs = [torch.zeros(1, 3, 4, 8) for _ in range(2)]
    with pytest.raises(ValueError, match="heads \\(3\\) divisible"):
        ulysses_attention(xs, xs, xs)


# -- quantized_dot ---------------------------------------------------------------

def test_quantized_dot_int8_exact():
    rng = np.random.default_rng(60)
    qx = rng.integers(-127, 128, (2, 3, 150), dtype=np.int8)
    qw = rng.integers(-127, 128, (150, 5), dtype=np.int8)
    sx = rng.uniform(0.01, 0.1, (2, 3)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (5,)).astype(np.float32)
    want = np.asarray(ref_quantized_dot(*(jnp.asarray(a) for a in
                                          (qx, qw, sx, sw)), "int8"))
    got = quantized_dot(*(torch.from_numpy(a) for a in (qx, qw, sx, sw)),
                        "int8")
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_dot_fp8_within_float32_summation():
    """fp8 products are exact in float32; only the order of the K
    float32 additions may differ: |got - ref| <= 2 K 2^-24 (|qx| @ |qw|)
    |sx sw|."""
    rng = np.random.default_rng(61)
    k = 96
    qx = jnp.asarray(rng.standard_normal((4, k)) * 20).astype(
        jnp.float8_e4m3fn)
    qw = jnp.asarray(rng.standard_normal((k, 6)) * 20).astype(
        jnp.float8_e4m3fn)
    sx = rng.uniform(0.01, 0.1, (4,)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (6,)).astype(np.float32)
    want = np.asarray(ref_quantized_dot(qx, qw, jnp.asarray(sx),
                                        jnp.asarray(sw), "fp8"))

    def fp8(a):
        return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(
            torch.float8_e4m3fn)

    got = quantized_dot(fp8(qx), fp8(qw), torch.from_numpy(sx),
                        torch.from_numpy(sw), "fp8").numpy()
    mag = (np.abs(np.asarray(qx, np.float32)) @
           np.abs(np.asarray(qw, np.float32))) * np.abs(sx[:, None] * sw)
    assert np.all(np.abs(got - want) <= 2 * k * 2.0 ** -24 * mag)
    with pytest.raises(ValueError, match="quantized mode"):
        quantized_dot(fp8(qx), fp8(qw), torch.from_numpy(sx),
                      torch.from_numpy(sw), "bf16")


# -- distributed ---------------------------------------------------------------

def test_initialize_distributed_single_process_is_a_no_op(monkeypatch):
    for var in ("ARBIUS_COORDINATOR", "ARBIUS_NUM_PROCESSES",
                "ARBIUS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is False
    assert distributed.initialize_distributed(num_processes=1) is False
    monkeypatch.setenv("ARBIUS_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("ARBIUS_NUM_PROCESSES", "4")
    monkeypatch.setenv("ARBIUS_PROCESS_ID", "2")
    assert distributed.distributed_env() == ("localhost:1234", 4, 2)
    assert distributed.distributed_env("h:1", 2, 0) == ("h:1", 2, 0)
    monkeypatch.delenv("ARBIUS_PROCESS_ID")
    with pytest.raises(ValueError, match="process count and this"):
        distributed.initialize_distributed()
