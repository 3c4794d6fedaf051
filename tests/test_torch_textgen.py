"""The port's textgen family against the JAX reference on the CPU, at the
tiny config in float32: the weight bridge, prefill and decode logits, the
bucket program's token ids for both samplers, `categorical`, top-k's order
among tied logits, prefix stability, `tokens_to_bytes`, the runner's
files and tags, and tiny textgen tasks mined by the port's MinerNode on
LocalChain.

Weights are the reference's own `init_params` (one jitted init), carried
across by `params_from_jax`; inputs come from numpy with a seed.

Tolerances: prefill and decode logits within 1e-5 (float32; matmul and
reduction orders differ between XLA and torch, measured 1.4e-6 on logits
of magnitude ~3). At bf16 the port's logits are held to the reference's
bf16 ones within the reference's own bf16-versus-float32 gap, largest
and mean (measured 0.19x and 0.25x of it): XLA keeps some bf16 chains in
float32 on the CPU where torch rounds each op. Token ids, tokens_to_bytes'
bytes, categorical's ids and the runner's files are held exactly: the
Gumbel noise itself differs from jax's by ulps of `log` (held within 1e-5
relative), so categorical is held over 4,096 keys, not a handful.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models.textgen import TextGenConfig as JConfig
from arbius_tpu.models.textgen import TextGenModel as JModel
from arbius_tpu.models.textgen import TextGenPipeline as JPipeline
from arbius_tpu.models.textgen import tokens_to_bytes as ref_tokens_to_bytes
from arbius_tpu.node.solver import TextGenRunner as RefRunner
from arbius_tpu_torch import random as trandom
from arbius_tpu_torch.models.sd15.bridge import params_from_jax
from arbius_tpu_torch.models.textgen import (
    EOS_ID,
    TextGenConfig,
    TextGenPipeline,
    tokens_to_bytes,
)
from arbius_tpu_torch.node.solver import TextGenRunner
from test_torch_node import MINER, USER, _config, _pkg

LOGIT_TOL = 1e-5
PROMPT_EDGES = (8, 16)
DECODE_EDGES = (4, 8)
TOP_K = 4
PROMPTS = ["hello world", "ab", "a much longer prompt than the edge",
           "été"]
SEEDS = [1, 2**40 + 3, 7, 0x1FFFFFFFFFFFEF]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny torch ops on one thread (the suite's workers
    share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(tree):
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def plain(node):
        return {k: plain(v) if hasattr(v, "items") else v
                for k, v in node.items()}

    return plain(tree)


@pytest.fixture(scope="module")
def pair():
    """(reference pipeline, its params, the port's pipeline with them)."""
    kw = dict(prompt_buckets=PROMPT_EDGES, decode_buckets=DECODE_EDGES,
              top_k=TOP_K)
    ref = JPipeline(dataclasses.replace(JConfig.tiny(), dtype="float32"),
                    **kw)
    params = _plain(ref.init_params(seed=0))
    port = TextGenPipeline(dataclasses.replace(TextGenConfig.tiny(),
                                               dtype="float32"),
                           device="cpu", **kw)
    state = params_from_jax(params)
    assert set(state) == set(port.model.state_dict())
    port.load_params(state)
    return ref, params, port


def test_prefill_and_decode_logits_match(pair):
    ref, params, port = pair
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 259, (3, 8))
    total = 12
    jl, jkv = ref.model.apply({"params": params}, jnp.asarray(ids), total,
                              method=JModel.prefill)
    tl, tkv = port.model.prefill(torch.from_numpy(ids), total)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=LOGIT_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=LOGIT_TOL)
    for pos in (8, 9, 11):   # the caches grow in place on the port's side
        tok = rng.integers(0, 259, (3,))
        jl, jkv = ref.model.apply({"params": params}, jnp.asarray(tok), jkv,
                                  pos, method=JModel.decode)
        tl = port.model.decode(torch.from_numpy(tok), tkv, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(tkv[0][0].numpy(), np.asarray(jkv[0][0]),
                                   atol=LOGIT_TOL)


def test_bf16_logits_within_the_reference_bf16_gap(pair):
    ref32, params, _ = pair
    kw = dict(prompt_buckets=PROMPT_EDGES, decode_buckets=DECODE_EDGES,
              top_k=TOP_K)
    ref16 = JPipeline(JConfig.tiny(), **kw)
    port = TextGenPipeline(TextGenConfig.tiny(), device="cpu", **kw)
    port.load_params(params_from_jax(params))
    ids = np.random.default_rng(3).integers(0, 259, (4, 16))
    total = 24
    want = []
    for ref in (ref16, ref32):
        logits, kv = ref.model.apply({"params": params}, jnp.asarray(ids),
                                     total, method=JModel.prefill)
        step, _ = ref.model.apply({"params": params}, jnp.asarray(ids[:, 0]),
                                  kv, 16, method=JModel.decode)
        want.append((np.asarray(logits), np.asarray(step)))
    tl, tkv = port.model.prefill(torch.from_numpy(ids), total)
    ts = port.model.decode(torch.from_numpy(ids[:, 0]), tkv, 16)
    for got, w16, w32 in zip((tl.numpy(), ts.numpy()), want[0], want[1]):
        gap, err = np.abs(w16 - w32), np.abs(got - w16)
        assert err.max() <= gap.max() and err.mean() <= gap.mean()


@pytest.mark.parametrize("sampler", ["greedy", "top_k"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("prompt_bucket", PROMPT_EDGES)
@pytest.mark.parametrize("decode_bucket", DECODE_EDGES)
def test_generate_ids_equal_reference(pair, sampler, batch, prompt_bucket,
                                      decode_bucket):
    ref, params, port = pair
    kw = dict(prompt_bucket=prompt_bucket, decode_bucket=decode_bucket,
              sampler=sampler)
    want = np.asarray(ref.generate(params, PROMPTS[:batch], SEEDS[:batch],
                                   **kw))
    got = port.generate(PROMPTS[:batch], SEEDS[:batch], **kw)
    assert got.shape == (batch, decode_bucket)
    np.testing.assert_array_equal(got, want)


def test_categorical_ids_exact():
    """4,096 folded keys, 8 logits each (top-k's k): ids equal
    jax.random.categorical's, the noise within ulps of jax.random.gumbel."""
    n = 4096
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (n, 8)).astype(np.float32)
    seeds = rng.integers(0, 2**53, n, dtype=np.uint64)
    lo = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (seeds >> np.uint64(32)).astype(np.uint32)

    def jkey(a, b, step):
        return jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(a), b), step)

    jkeys = jax.vmap(jkey, (0, 0, None))(jnp.asarray(lo), jnp.asarray(hi), 5)
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jkeys, jnp.asarray(logits)))
    tkeys = trandom.fold_in(trandom.fold_in(
        trandom.prng_key(torch.from_numpy(lo.astype(np.int64)), "cpu"),
        torch.from_numpy(hi.astype(np.int64))), 5)
    np.testing.assert_array_equal(np.asarray(jkeys).astype(np.int64),
                                  tkeys.numpy())
    got = trandom.categorical(tkeys, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    g_want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (8,)))(jkeys))
    np.testing.assert_allclose(trandom.gumbel(tkeys, (8,)).numpy(), g_want,
                               rtol=1e-5, atol=1e-6)


def test_top_k_order_among_ties(pair):
    """Rows with runs of equal logits around the k-th place: the port's
    stable descending sort picks lax.top_k's candidates in its order (the
    lower index first), so the sampled ids are the reference's."""
    ref, _, port = pair
    rng = np.random.default_rng(11)
    rows = rng.normal(0, 1, (16, 512)).astype(np.float32)
    for r in rows:   # ties inside and across the top k
        top = np.argsort(-r)[:6]
        r[rng.choice(512, 5, replace=False)] = r[top[0]]
        r[top[3:6]] = r[top[2]]
    seeds = np.arange(16, dtype=np.uint32) * 977
    jkeys = jax.vmap(lambda a: jax.random.fold_in(
        jax.random.PRNGKey(a), 0))(jnp.asarray(seeds))
    tkeys = trandom.fold_in(trandom.prng_key(
        torch.from_numpy(seeds.astype(np.int64)), "cpu"), 0)
    for step in (0, 3):
        want = np.asarray(ref._sampler_fn("top_k")(jnp.asarray(rows), jkeys,
                                                   step))
        got = port._sample("top_k", torch.from_numpy(rows), tkeys,
                           step).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port._sample("greedy", torch.from_numpy(rows), tkeys, 0).numpy(),
        np.asarray(ref._sampler_fn("greedy")(jnp.asarray(rows), jkeys, 0)))


@pytest.mark.parametrize("sampler", ["greedy", "top_k"])
def test_prefix_stability(pair, sampler):
    """The decode edge touches no bytes: the longer bucket's first tokens
    are the shorter bucket's."""
    _, _, port = pair
    short, long = (port.generate(PROMPTS, SEEDS, prompt_bucket=16,
                                 decode_bucket=t, sampler=sampler)
                   for t in DECODE_EDGES)
    np.testing.assert_array_equal(long[:, :DECODE_EDGES[0]], short)


def test_tokens_to_bytes_equal_reference():
    rng = np.random.default_rng(2)
    for _ in range(50):
        ids = rng.integers(0, 512, 24)
        ids[rng.integers(0, 24, 2)] = rng.choice([EOS_ID, 257, 255, 0], 2)
        for limit in (0, 5, 24, 40):
            assert tokens_to_bytes(ids, limit) == \
                ref_tokens_to_bytes(ids, limit)


@pytest.mark.parametrize("hydrated", [
    {"prompt": "hello there", "max_new_tokens": 3, "sampler": "top_k"},
    {"prompt": "x" * 30, "max_new_tokens": 8, "sampler": "greedy"},
    {"prompt": "", "max_new_tokens": None, "sampler": None},
])
def test_runner_files_and_tags_equal_reference(pair, hydrated):
    """The port's runner gives the reference runner's hydrated fields,
    cache tags and files for the same input and seed."""
    ref, params, port = pair
    ours, theirs = TextGenRunner(port), RefRunner(ref, params)
    h = ours.prepare_hydrated(hydrated)
    assert h == theirs.prepare_hydrated(hydrated)
    assert ours.cache_tag(h, 2) == theirs.cache_tag(h, 2)
    items = [(h, 11), (h, 2**40 + 3)]
    assert ours.run_batch(items) == theirs.run_batch(items)


def test_decode_stall_counted():
    """A task whose decode gives no bytes (an immediate eos) is committed
    as empty and counted in arbius_decode_stalls_total."""
    from arbius_tpu_torch.obs import Obs, use_obs

    runner = TextGenRunner(TextGenPipeline(TextGenConfig.tiny(),
                                           device="cpu"))
    tokens = torch.tensor([[EOS_ID, 65, 66], [72, 105, EOS_ID],
                           [257, EOS_ID, 65]])
    obs = Obs()
    with use_obs(obs):
        files = runner.finalize(((tokens, None), [3, 3, 3]), 3)
    assert [f["out-1.txt"] for f in files] == [b"", b"Hi", b""]
    text = obs.registry.render()
    assert "arbius_decode_stalls_total 2" in text


def test_textgen_mines_on_local_chain():
    """Tiny textgen (bf16 weights, the port's seeded init) mined by the
    port's MinerNode on LocalChain at canonical batch 2: tasks of both
    samplers and two prompt buckets, through reveal and claim; each
    on-chain CID equals a fresh registry's direct solve of the same
    hydrated input and seed in another chunking."""
    P = _pkg("arbius_tpu_torch")
    WAD = P.WAD
    template = P.load_template("textgen")
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, P.Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(USER, USER, 0, b'{"meta":{}}')
    mid = "0x" + mid_b.hex()
    cfg = _config(P, canonical_batch=2, models=(P.node.ModelConfig(
        id=mid, template="textgen", tiny=True, weights_dtype="bfloat16"),))
    chain = P.node.LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    node = P.node.MinerNode(chain, cfg, P.node.build_registry(
        cfg, device="cpu"))
    node.boot()
    inputs = [{"prompt": "once upon a time", "sampler": "top_k"},
              {"prompt": "the sea", "max_new_tokens": 5, "sampler": "top_k"},
              {"prompt": "a" * 40, "max_new_tokens": 20},
              {"prompt": "tell me", "sampler": "top_k"}]
    tids = ["0x" + eng.submit_task(USER, 0, USER, mid_b, WAD, json.dumps(
        raw).encode()).hex() for raw in inputs]
    while node.tick():
        pass
    bal0 = tok.balance_of(MINER)
    eng.advance_time(2000 + 121)
    while node.tick():
        pass
    assert node.db.failed_jobs() == []
    fresh = P.node.build_registry(cfg, device="cpu").get(mid)
    for i in (3, 2, 1, 0):
        hydrated = fresh.runner.prepare_hydrated(
            P.hydrate_input(dict(inputs[i]), template))
        [(cid, files)] = P.node.solve_cid_batch(
            fresh, [(hydrated, P.taskid2seed(tids[i]))], canonical_batch=2)
        sol = eng.solutions[bytes.fromhex(tids[i][2:])]
        assert sol.claimed and "0x" + sol.cid.hex() == cid
    assert len(files["out-1.txt"]) <= 16
    assert tok.balance_of(MINER) - bal0 == len(tids) * WAD * 9 // 10
