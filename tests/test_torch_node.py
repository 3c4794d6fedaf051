"""The port's miner node against the reference's, on the CPU.

Differential scenarios: both packages' `Engine` + `LocalChain` +
`MinerNode` run the same script (the scenarios of tests/test_node.py)
with the same fake deterministic runner. Each case runs one scenario in
one package, holds the scenario's own checks, and requires the chain
state (solutions, commitments, contestations, validators, balances), the
node counters and the failed jobs to equal a run of the reference's.

The real runner: the tiny float32 anythingv3 (the reference's init
carried across by the bridge) mines tasks through the port's node at
128x128, 2 steps, canonical batch 2; each on-chain CID equals the port's
`solve_cid_batch` and the reference's PNG-and-CID path on the port's
images, whatever the arrival order. Then the boot self-test against a
golden from the port's record-golden, the tiny kandinsky2 model booting
with its own recorded golden and mining a task, the settings the port
refuses at boot, and `demo-mine` in a process where JAX and arbius_tpu
cannot be imported.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("arbius_tpu", "arbius_tpu_torch")

MINER = "0x" + "aa" * 20
OTHER = "0x" + "bb" * 20
USER = "0x" + "01" * 20
MODEL_ADDR = "0x" + "33" * 20
COUNTERS = ("solutions_submitted", "solutions_claimed",
            "contestations_submitted", "votes_cast", "vote_finishes",
            "tasks_seen", "tasks_invalid", "tasks_unprofitable")


@functools.cache
def _pkg(name: str) -> types.SimpleNamespace:
    chain = importlib.import_module(f"{name}.chain")
    engine = importlib.import_module(f"{name}.templates.engine")
    cid = importlib.import_module(f"{name}.l0.cid")
    commitment = importlib.import_module(f"{name}.l0.commitment")
    return types.SimpleNamespace(
        name=name, Engine=chain.Engine, TokenLedger=chain.TokenLedger,
        WAD=chain.WAD, node=importlib.import_module(f"{name}.node"),
        load_template=engine.load_template,
        hydrate_input=engine.hydrate_input, cid_hex=cid.cid_hex,
        cid_of=cid.cid_of_solution_files, taskid2seed=commitment.taskid2seed)


def fake_runner(hydrated: dict, seed: int) -> dict:
    """Deterministic in (input, seed); output depends on both."""
    blob = json.dumps({k: v for k, v in sorted(hydrated.items())
                       if k != "seed"}).encode() + seed.to_bytes(8, "big")
    return {"out-1.png": b"\x89PNG" + blob}


def _config(P, **kw):
    # the reference's default compile_cache_dir turns on JAX's cache;
    # the port has none
    return P.node.MiningConfig(compile_cache_dir=None, **kw)


def build_world(P, *, evilmode=False, automine=None, miner_stake=100,
                **cfg_overrides):
    WAD = P.WAD
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, OTHER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, P.Engine.ADDRESS, 10**30)
    mid = "0x" + eng.register_model(USER, MODEL_ADDR, 0,
                                    b'{"meta":{"title":"anything"}}').hex()
    registry = P.node.ModelRegistry()
    registry.register(P.node.RegisteredModel(
        id=mid, template=P.load_template("anythingv3"), runner=fake_runner))
    chain = P.node.LocalChain(eng, MINER)
    if miner_stake:
        chain.validator_deposit(miner_stake * WAD)
    cfg = _config(P, evilmode=evilmode,
                  models=(P.node.ModelConfig(id=mid, template="anythingv3"),),
                  automine=automine or P.node.AutomineConfig(),
                  **cfg_overrides)
    node = P.node.MinerNode(chain, cfg, registry)
    node.boot()
    drain(node)
    return types.SimpleNamespace(eng=eng, tok=tok, chain=chain, node=node,
                                 mid=mid, nodes=[node], notes={})


def drain(node, n=10):
    total = 0
    for _ in range(n):
        done = node.tick()
        total += done
        if done == 0:
            break
    return total


def submit(w, prompt="a cat", fee=0):
    return "0x" + w.eng.submit_task(
        USER, 0, USER, bytes.fromhex(w.mid[2:]), fee,
        json.dumps({"prompt": prompt, "negative_prompt": ""}).encode()).hex()


def solution(w, tid):
    return w.eng.solutions.get(bytes.fromhex(tid[2:]))


def expected_cid(P, w, tid):
    raw = json.loads(w.eng.task_input_data[bytes.fromhex(tid[2:])])
    hydrated = P.hydrate_input(raw, P.load_template("anythingv3"))
    hydrated["seed"] = P.taskid2seed(tid)
    return P.cid_hex(P.cid_of(fake_runner(hydrated, hydrated["seed"])))


def _lost_response(fn):
    def wrapped(*args, **kwargs):
        fn(*args, **kwargs)
        raise OSError("sim: response lost after landing")
    return wrapped


# -- scenarios (tests/test_node.py) -----------------------------------------

def sc_task_to_solution_to_claim(P):
    w = build_world(P)
    tid = submit(w, fee=10 * P.WAD)
    drain(w.node)
    sol = solution(w, tid)
    assert sol.validator == MINER
    assert "0x" + sol.cid.hex() == expected_cid(P, w, tid)
    bal0 = w.tok.balance_of(MINER)
    w.eng.advance_time(2000 + 121)
    drain(w.node)
    assert w.node.metrics.solutions_claimed == 1
    assert w.tok.balance_of(MINER) - bal0 == 9 * P.WAD
    return w


def sc_deterministic_per_taskid(P):
    w = build_world(P)
    t1, t2 = submit(w, "same prompt"), submit(w, "same prompt")
    drain(w.node)
    assert solution(w, t1).cid != solution(w, t2).cid
    return w


def sc_unknown_model(P):
    w = build_world(P)
    other = w.eng.register_model(USER, MODEL_ADDR, 0, b"other template")
    w.eng.submit_task(USER, 0, USER, other, 0,
                      json.dumps({"prompt": "a", "negative_prompt": ""})
                      .encode())
    assert drain(w.node) == 0
    assert w.node.db.job_count() == 1
    return w


def sc_min_fee(P):
    w = build_world(P)
    m = w.node.registry.get(w.mid)
    w.node.registry.register(P.node.RegisteredModel(
        id=w.mid, template=m.template, runner=m.runner, min_fee=5 * P.WAD))
    low, ok = submit(w, fee=1 * P.WAD), submit(w, fee=5 * P.WAD)
    drain(w.node)
    assert solution(w, low) is None and solution(w, ok) is not None
    return w


def sc_invalid_input_contests(P):
    w = build_world(P)
    other = P.node.LocalChain(w.eng, OTHER)
    other.validator_deposit(100 * P.WAD)
    tid = "0x" + w.eng.submit_task(USER, 0, USER, bytes.fromhex(w.mid[2:]),
                                   0, b"this is not json").hex()
    drain(w.node)
    assert w.node.db.is_invalid_task(tid) and solution(w, tid) is None
    bad_cid = "0x1220" + "cc" * 32
    other.signal_commitment(other.generate_commitment(tid, bad_cid))
    other.submit_solution(tid, bad_cid)
    drain(w.node)
    assert w.node.metrics.contestations_submitted == 1
    assert w.eng.contestations[bytes.fromhex(tid[2:])].validator == MINER
    return w


def sc_evilmode_contested(P):
    w = build_world(P, evilmode=True)
    honest_chain = P.node.LocalChain(w.eng, OTHER)
    honest_chain.validator_deposit(100 * P.WAD)
    registry = P.node.ModelRegistry()
    registry.register(P.node.RegisteredModel(
        id=w.mid, template=P.load_template("anythingv3"), runner=fake_runner))
    honest = P.node.MinerNode(honest_chain, _config(P, models=(
        P.node.ModelConfig(id=w.mid, template="anythingv3"),)), registry)
    honest.boot()
    w.nodes.append(honest)
    tid = submit(w)
    drain(w.node)
    assert solution(w, tid).cid.endswith(b"\x06\x66")
    drain(honest)
    assert honest.metrics.contestations_submitted == 1
    assert w.eng.contestations[bytes.fromhex(tid[2:])].validator == OTHER
    return w


def sc_stake_topup(P):
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 590_000 * P.WAD)
    tok.mint(MINER, 1_000 * P.WAD)
    tok.approve(MINER, P.Engine.ADDRESS, 10**30)
    node = P.node.MinerNode(P.node.LocalChain(eng, MINER), _config(P),
                            P.node.ModelRegistry())
    node.boot()
    drain(node)
    minimum = eng.get_validator_minimum()
    assert eng.validators[MINER].staked == pytest.approx(minimum * 1.2,
                                                         rel=0.01)
    assert node.db.job_count() == 1
    return types.SimpleNamespace(eng=eng, tok=tok, nodes=[node], notes={})


def sc_automine(P):
    w = build_world(P)
    w.node.config = _config(P, models=w.node.config.models,
                            automine=P.node.AutomineConfig(
                                enabled=True, model=w.mid, fee=0, delay=60,
                                input={"prompt": "self work",
                                       "negative_prompt": ""}))
    w.node.db.queue_job("automine", {}, priority=10)
    drain(w.node)
    assert w.node.metrics.solutions_submitted == 1
    w.eng.advance_time(61)
    drain(w.node)
    assert w.node.metrics.solutions_submitted == 2
    return w


def sc_boot_golden(P):
    w = build_world(P)
    m = w.node.registry.get(w.mid)
    inp = {"prompt": "arbius test cat", "negative_prompt": ""}
    good = P.cid_hex(P.cid_of(fake_runner(
        P.hydrate_input(dict(inp), m.template), 1337)))
    for cid in (good, "0x1220" + "00" * 32):
        w.node.registry.register(P.node.RegisteredModel(
            id=w.mid, template=m.template, runner=m.runner,
            golden=(inp, 1337, cid)))
        try:
            w.node.boot()
            w.notes[cid] = "booted"
        except P.node.BootError as e:
            w.notes[cid] = str(e)
    assert w.notes[good] == "booted"
    assert "self-test failed" in w.notes["0x1220" + "00" * 32]
    return w


def sc_version_check(P):
    w = build_world(P)
    w.eng.set_version(99)
    with pytest.raises(P.node.BootError, match="version") as e:
        w.node.boot()
    w.notes["error"] = str(e.value)
    return w


def sc_quarantine(P):
    w = build_world(P)

    def broken_runner(hydrated, seed):
        raise RuntimeError("model exploded")

    m = w.node.registry.get(w.mid)
    w.node.registry.register(P.node.RegisteredModel(
        id=w.mid, template=m.template, runner=broken_runner))
    submit(w)
    drain(w.node)
    assert any(name == "solve" for name, _ in w.node.db.failed_jobs())
    assert all(j.method == "validatorStake"
               for j in w.node.db.get_jobs(now=10**12))
    return w


def sc_config_validation(P):
    w = build_world(P)
    cfg = P.node.load_config(json.dumps({
        "db_path": ":memory:",
        "models": [{"id": "0x" + "ab" * 32, "template": "anythingv3"}],
        "automine": {"enabled": True, "delay": 30}}))
    w.notes["config"] = (cfg.models[0].template, cfg.automine.delay)
    for bad in ('{"not_a_key": 1}', '{"stake": {"nope": 1}}',
                '{"models": [{"id": "0x01"}]}'):
        with pytest.raises(P.node.ConfigError) as e:
            P.node.load_config(bad)
        w.notes[bad] = str(e.value)
    return w


def sc_one_dispatch_of_4(P):
    w = build_world(P)
    batches = []

    class BatchRunner:
        def __call__(self, hydrated, seed):
            return self.run_batch([(hydrated, seed)])[0]

        def run_batch(self, items):
            batches.append(len(items))
            return [fake_runner(h, s) for h, s in items]

    m = w.node.registry.get(w.mid)
    w.node.registry.register(P.node.RegisteredModel(
        id=w.mid, template=m.template, runner=BatchRunner()))
    w.node.config = _config(P, models=w.node.config.models,
                            canonical_batch=4)
    tids = [submit(w, f"p{i}") for i in range(3)]
    drain(w.node)
    assert batches == [4]
    assert all(solution(w, t) is not None for t in tids)
    w.notes["batches"] = batches
    return w


def sc_lost_reveal(P):
    w = build_world(P)
    w.chain.submit_solution = _lost_response(w.chain.submit_solution)
    tid = submit(w, fee=10 * P.WAD)
    drain(w.node)
    assert solution(w, tid).validator == MINER
    assert w.node.db.has_job("claim", {"taskid": tid})
    w.eng.advance_time(2000 + 121)
    drain(w.node)
    assert w.node.metrics.solutions_claimed == 1
    return w


def sc_lost_claim(P):
    w = build_world(P)
    tid = submit(w, fee=10 * P.WAD)
    drain(w.node)
    w.chain.claim_solution = _lost_response(w.chain.claim_solution)
    w.eng.advance_time(2000 + 121)
    drain(w.node)
    assert solution(w, tid).claimed
    assert w.node.db.failed_jobs() == []
    return w


def sc_claim_latency_metrics(P):
    w = build_world(P)
    submit(w)
    drain(w.node)
    m = w.node.metrics
    w.notes["recorded"] = (len(m.solve_latency), len(m.stage_seconds["infer"]),
                           len(m.stage_seconds["commit"]))
    assert w.notes["recorded"] == (1, 1, 1)
    return w


def sc_db_prune_keeps_unclaimed(P):
    w = build_world(P)
    t_old = submit(w, prompt="old")
    drain(w.node)
    w.eng.advance_time(2200)
    drain(w.node)  # claimed
    t_new = submit(w, prompt="new")
    drain(w.node)  # solved, not claimed yet
    w.notes["removed"] = w.node.db.prune_before(w.eng.now + 10**6)
    assert w.notes["removed"] == 1
    assert w.node.db.get_task(t_old) is None
    assert w.node.db.get_task(t_new) is not None
    return w


def sc_delegated_validator_stake_seam(P):
    """With `delegated_validator`, stake reads and the auto-top-up target
    the delegated address; the node's own wallet pays but never stakes;
    the caveat is logged at boot."""
    import logging

    delegated = "0x" + "dd" * 20
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 590_000 * P.WAD)
    tok.mint(MINER, 1_000 * P.WAD)
    tok.approve(MINER, P.Engine.ADDRESS, 10**30)
    chain = P.node.LocalChain(eng, MINER, validator_address=delegated)
    node = P.node.MinerNode(
        chain, _config(P, delegated_validator=delegated),
        P.node.ModelRegistry())
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("arbius.node").addHandler(handler)
    try:
        node.boot()
    finally:
        logging.getLogger("arbius.node").removeHandler(handler)
    assert any("delegated_validator" in r.getMessage() for r in records)
    drain(node)
    assert eng.validators[delegated].staked >= eng.get_validator_minimum()
    assert MINER not in eng.validators
    assert chain.validator_staked() == eng.validators[delegated].staked
    with pytest.raises(P.node.ConfigError, match="delegated_validator"):
        P.node.MiningConfig(delegated_validator="not-an-address")
    return types.SimpleNamespace(eng=eng, tok=tok, chain=chain, node=node,
                                 mid=None, nodes=[node], notes={})


def sc_reveal_never_lands(P):
    w = build_world(P)

    def down(*a, **k):
        raise OSError("sim: endpoint down")

    w.chain.submit_solution = down
    tid = submit(w)
    drain(w.node)
    assert "solve" in {m for m, d in w.node.db.failed_jobs()
                       if d.get("taskid") == tid}
    assert solution(w, tid) is None
    return w


def sc_stake_heartbeat_survives_chain_fault(P):
    w = build_world(P)
    orig = w.chain.validator_staked

    def down():
        raise OSError("sim: endpoint down")

    w.chain.validator_staked = down
    w.eng.advance_time(700)
    drain(w.node)
    assert any(m == "validatorStake" for m, _ in w.node.db.failed_jobs())
    assert w.node.db.has_job("validatorStake", {})
    w.chain.validator_staked = orig
    w.eng.advance_time(700)
    drain(w.node)
    return w


def _db_world(P):
    w = build_world(P)
    w.db = P.node.NodeDB(":memory:")
    return w


def sc_get_jobs_priority_then_id(P):
    w = _db_world(P)
    db = w.db
    ids = [db.queue_job("a", {"n": i}) for i in range(3)]
    hot = db.queue_job("hot", {}, priority=50)
    warm = db.queue_job("warm", {}, priority=10)
    assert [j.id for j in db.get_jobs(now=0)] == [hot, warm] + ids
    db.delete_job(ids[1])
    w.notes["after_delete"] = [j.data.get("n") for j in db.get_jobs(now=0)
                               if j.method == "a"]
    assert w.notes["after_delete"] == [0, 2]
    db.close()
    return w


def sc_get_jobs_limit_boundary(P):
    w = _db_world(P)
    db = w.db
    for i in range(101):
        db.queue_job("a", {"n": i})
    w.notes["counts"] = [len(db.get_jobs(now=0)),
                         len(db.get_jobs(now=0, limit=101)),
                         len(db.get_jobs(now=0, limit=1))]
    assert w.notes["counts"] == [100, 101, 1]
    db.close()
    return w


def sc_get_jobs_excludes_future_waituntil(P):
    w = _db_world(P)
    db = w.db
    due = db.queue_job("now", {}, waituntil=100)
    edge = db.queue_job("edge", {}, waituntil=200)
    db.queue_job("later", {}, waituntil=201)
    assert [j.id for j in db.get_jobs(now=100)] == [due]
    assert [j.id for j in db.get_jobs(now=200)] == [due, edge]
    w.notes["due"] = [j.method for j in db.get_jobs(now=200)]
    db.close()
    return w


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_task_to_solution_to_claim, sc_deterministic_per_taskid,
    sc_unknown_model, sc_min_fee, sc_invalid_input_contests,
    sc_evilmode_contested, sc_stake_topup, sc_automine, sc_boot_golden,
    sc_version_check, sc_quarantine, sc_config_validation,
    sc_one_dispatch_of_4, sc_lost_reveal, sc_lost_claim,
    sc_claim_latency_metrics, sc_db_prune_keeps_unclaimed,
    sc_delegated_validator_stake_seam, sc_reveal_never_lands,
    sc_stake_heartbeat_survives_chain_fault, sc_get_jobs_priority_then_id,
    sc_get_jobs_limit_boundary, sc_get_jobs_excludes_future_waituntil)}


def _state(w) -> dict:
    """What both packages must agree on after a scenario."""
    eng = w.eng

    def rows(table):
        return {k.hex(): dataclasses.astuple(v) for k, v in
                sorted(table.items())}

    nodes = []
    for node in w.nodes:
        failed = node.obs.registry.counter(
            "arbius_jobs_failed_total", labelnames=("method",))
        nodes.append({
            "counters": {c: getattr(node.metrics, c) for c in COUNTERS},
            "jobs_failed": failed.summary(),
            "failed_jobs": node.db.failed_jobs(),
            "jobs": node.db.job_count()})
    return {"solutions": rows(eng.solutions),
            "commitments": {k.hex(): v for k, v in
                            sorted(eng.commitments.items())},
            "contestations": rows(eng.contestations),
            "validators": {k: dataclasses.astuple(v) for k, v in
                           sorted(eng.validators.items())},
            "balances": dict(sorted(w.tok.balances.items())),
            "now": eng.now, "nodes": nodes, "notes": w.notes}


@functools.cache
def _reference_state(name: str) -> dict:
    return _state(SCENARIOS[name](_pkg("arbius_tpu")))


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_node_scenario_matches_reference(name, pkg):
    """The scenario's own checks hold in `pkg`, and its chain state,
    counters and failed jobs equal a run of the reference's (for the
    reference itself: a second, fresh run)."""
    got = _state(SCENARIOS[name](_pkg(pkg)))
    assert got == _reference_state(name)


# -- the real runner --------------------------------------------------------

CANONICAL = 2


@pytest.fixture(scope="module")
def params():
    from arbius_tpu.models.sd15 import SD15Config, SD15Pipeline
    from arbius_tpu_torch.models.sd15 import params_from_jax

    tree = jax.tree_util.tree_map(
        np.asarray, SD15Pipeline(SD15Config.tiny()).init_params(seed=0))
    return params_from_jax(tree)


@pytest.fixture(scope="module")
def registry(params):
    P = _pkg("arbius_tpu_torch")
    cfg = _config(P, models=(P.node.ModelConfig(
        id="0x" + "00" * 32, template="anythingv3", tiny=True),))
    return P.node.build_registry(cfg, device="cpu", params=params)


def _task(i):
    return {"prompt": f"a lighthouse, study {i}", "negative_prompt": "",
            "width": 128, "height": 128, "num_inference_steps": 2,
            "guidance_scale": 5.0 + i}


def _mine(registry, order, golden=None):
    """A port world whose node (the tiny model, canonical batch 2) mines
    the tasks `order` in that order; returns (world, [(taskid, hydrated,
    on-chain cid)])."""
    P = _pkg("arbius_tpu_torch")
    WAD = P.WAD
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, P.Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(USER, MODEL_ADDR, 0, b'{"meta":{}}')
    m = registry.get("0x" + "00" * 32)
    reg = P.node.ModelRegistry()
    reg.register(P.node.RegisteredModel(
        id="0x" + mid_b.hex(), template=m.template, runner=m.runner,
        golden=golden))
    chain = P.node.LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    node = P.node.MinerNode(chain, _config(P, canonical_batch=CANONICAL,
                                           models=(P.node.ModelConfig(
                                               id="0x" + mid_b.hex(),
                                               template="anythingv3"),)),
                            reg)
    node.boot()
    tids = ["0x" + eng.submit_task(USER, 0, USER, mid_b, WAD,
                                   json.dumps(_task(i)).encode()).hex()
            for i in order]
    while node.tick():
        pass
    bal0 = tok.balance_of(MINER)
    eng.advance_time(2000 + 121)
    while node.tick():
        pass
    assert node.metrics.solutions_claimed == len(order)
    assert tok.balance_of(MINER) - bal0 == len(order) * WAD * 9 // 10
    out = []
    for tid, i in zip(tids, order):
        hydrated = P.hydrate_input(_task(i), m.template)
        out.append((tid, hydrated,
                    "0x" + eng.solutions[bytes.fromhex(tid[2:])].cid.hex()))
    return out


@pytest.fixture(scope="module")
def mined(registry):
    return _mine(registry, [0, 1, 2])


def test_node_cids_equal_solve_cid_batch_and_reference_path(registry, mined):
    """Each on-chain CID equals the port's solve_cid_batch on the same
    (hydrated, taskid2seed(taskid)), solved in another grouping, and the
    reference's solve_cid_batch on the port's images."""
    from arbius_tpu.codecs import encode_png as ref_encode_png
    from arbius_tpu.node import solver as ref_solver
    from arbius_tpu.templates import load_template as ref_load_template
    from arbius_tpu_torch.node import solve_cid_batch

    P = _pkg("arbius_tpu_torch")
    model = registry.get("0x" + "00" * 32)
    items = [(h, P.taskid2seed(tid)) for tid, h, _ in mined]
    onchain = [cid for _, _, cid in mined]
    again = solve_cid_batch(model, items[::-1], canonical_batch=CANONICAL)
    assert [c for c, _ in again][::-1] == onchain

    pipe = model.runner.pipeline
    images = {}
    for h, s in items:
        [img] = pipe.generate([h["prompt"]], [h["negative_prompt"]], [s],
                              width=128, height=128, num_inference_steps=2,
                              guidance_scale=[h["guidance_scale"]],
                              scheduler=h["scheduler"])
        images[s] = img

    class Replay:
        def run_batch(self, batch):
            return [{"out-1.png": ref_encode_png(images[s])}
                    for _, s in batch]

    ref_model = ref_solver.RegisteredModel(
        id=model.id, template=ref_load_template("anythingv3"),
        runner=Replay())
    want = ref_solver.solve_cid_batch(ref_model, items,
                                      canonical_batch=CANONICAL)
    assert [c for c, _ in want] == onchain


def test_node_cids_independent_of_arrival_order(registry, mined):
    """Mined in the reverse order (other taskids, other chunks), every
    CID still equals solve_cid_batch on its own (hydrated, seed), and
    the hydrated inputs are those of the first world."""
    from arbius_tpu_torch.node import solve_cid_batch

    P = _pkg("arbius_tpu_torch")
    model = registry.get("0x" + "00" * 32)
    rev = _mine(registry, [2, 1, 0])
    assert [h for _, h, _ in rev] == [h for _, h, _ in mined][::-1]
    for tid, h, cid in rev:
        [(want, _)] = solve_cid_batch(model, [(h, P.taskid2seed(tid))],
                                      canonical_batch=CANONICAL)
        assert cid == want


@pytest.mark.parametrize("corrupt", [False, True])
def test_boot_self_test_with_recorded_golden(registry, corrupt):
    """A golden from the port's record-golden passes the boot self-test;
    one hex digit changed raises BootError."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.node import BootError

    model = registry.get("0x" + "00" * 32)
    raw = {"prompt": "arbius test cat", "negative_prompt": "",
           "width": 128, "height": 128, "num_inference_steps": 2}
    rec = record_golden(model, raw, 1337, canonical_batch=CANONICAL,
                        device="cpu")
    g = rec["golden"]
    assert rec["build"]["platform"] == "cpu"
    cid = g["cid"]
    if corrupt:
        cid = cid[:-1] + ("0" if cid[-1] != "0" else "1")
        with pytest.raises(BootError, match="self-test failed"):
            _mine(registry, [0], golden=(g["input"], g["seed"], cid))
    else:
        _mine(registry, [0], golden=(g["input"], g["seed"], cid))


@pytest.fixture
def one_torch_thread():
    """A test's tiny torch ops on one thread: with the suite's workers
    sharing the host's cores, torch's per-op thread pool otherwise waits
    on oversubscribed cores at every small op."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_int8_anythingv3_mines_in_its_mode(params, one_torch_thread):
    """A tiny anythingv3 served in int8 on LocalChain: the registry built
    from a MiningConfig whose precision names int8 holds quantized
    weights; a golden recorded on it passes the boot self-test; two
    tasks mine and claim with CIDs equal to the runner's solve and unlike
    the bf16 model's; the bucket key, the cost model's row (as fitted
    and as persisted) and `arbius_precision_models` carry int8."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.node import solve_cid_batch
    from arbius_tpu_torch.node.config import PrecisionConfig
    from arbius_tpu_torch.node.solver import bucket_key

    P = _pkg("arbius_tpu_torch")
    WAD = P.WAD
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, P.Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(USER, MODEL_ADDR, 0, b'{"meta":{}}')
    mid = "0x" + mid_b.hex()
    precision = PrecisionConfig(templates={"anythingv3": "int8"})

    def config(golden=None):
        return _config(P, canonical_batch=CANONICAL, precision=precision,
                       models=(P.node.ModelConfig(
                           id=mid, template="anythingv3", tiny=True,
                           golden=golden),))

    raw = {"prompt": "arbius test cat", "negative_prompt": "",
           "width": 128, "height": 128, "num_inference_steps": 2}
    rec = record_golden(P.node.build_registry(
        config(), device="cpu", params=params).get(mid), raw, 1337,
        canonical_batch=CANONICAL, device="cpu")
    cfg = config(rec["golden"])
    registry = P.node.build_registry(cfg, device="cpu", params=params)
    model = registry.get(mid)
    assert model.runner.pipeline.precision == "int8"
    assert model.runner.pipeline.quantized.leaves
    chain = P.node.LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    node = P.node.MinerNode(chain, cfg, registry)
    node.boot()    # the self-test solves the int8 golden
    tids = ["0x" + eng.submit_task(USER, 0, USER, mid_b, WAD,
                                   json.dumps(_task(i)).encode()).hex()
            for i in (0, 1)]
    while node.tick():
        pass
    eng.advance_time(2000 + 121)
    while node.tick():
        pass
    assert node.metrics.solutions_claimed == 2
    items = [(P.hydrate_input(_task(i), model.template), P.taskid2seed(t))
             for i, t in zip((0, 1), tids)]
    onchain = ["0x" + eng.solutions[bytes.fromhex(t[2:])].cid.hex()
               for t in tids]
    assert [c for c, _ in solve_cid_batch(
        model, items, canonical_batch=CANONICAL)] == onchain
    bf16_model = P.node.build_registry(_config(P, models=(
        P.node.ModelConfig(id=mid, template="anythingv3", tiny=True),)),
        device="cpu", params=params).get(mid)
    assert bf16_model.runner.pipeline.quantized is None
    bf16 = solve_cid_batch(bf16_model, items, canonical_batch=CANONICAL)
    assert all(a != b for (a, _), b in zip(bf16, onchain))

    key = bucket_key(mid, items[0][0], node.solve_mode(mid))
    assert node.solve_mode(mid) == "int8" and key[6] == "int8"
    assert model.runner.cache_tag(items[0][0], CANONICAL).endswith(".int8")
    assert {r.mode for r in node.costmodel.rows.values()} == {"int8"}
    assert {row[3] for row in node.db.load_cost_rows()} == {"int8"}
    text = node.obs.registry.render()
    assert 'arbius_precision_models{mode="int8"} 1' in text
    assert 'arbius_precision_models{mode="bf16"} 0' in text
    node.close()


# -- settings the port refuses ---------------------------------------------

@pytest.mark.parametrize("overrides,item", [
    ({"mesh": {"dp": 2}}, "lanes"),
    ({"mesh": {"dp": 2, "tp": 2},
      "models": [{"id": "0x" + "cc" * 32, "template": "anythingv3"}]}, 11),
    ({"mesh": {"dp": 2},
      "models": [{"id": "0x" + "cb" * 32, "template": "kandinsky2"}]}, 11),
    ({"mesh": {"dp": 2},
      "models": [{"id": "0x" + "cd" * 32, "template": "textgen"}]}, 11),
    ({"mesh": {"pp": 2}}, 11),
    ({"aot_cache": {"enabled": True}}, 12),
    ({"compile_cache_dir": ".jax_cache"}, 12),
    ({"perfscope": {"enabled": True}}, 12),
    ({"alerts": {"enabled": True}}, "boots"),
    ({"fleet": {"enabled": True}}, "boots"),
    ({"precision": {"default": "int8"},
      "models": [{"id": "0x" + "cd" * 32, "template": "textgen"}]}, None),
    ({"precision": {"templates": {"textgen": "fp8", "anythingv3": "fp8"}},
      "models": [{"id": "0x" + "cd" * 32, "template": "textgen"}]}, None),
    ({"precision": {"default": "int8"},
      "models": [{"id": "0x" + "cf" * 32,
                  "template": "robust_video_matting"}]}, "bf16"),
    ({"models": [{"id": "0x" + "cd" * 32, "template": "textgen"}]}, None),
    ({"mesh": {"sp": 2}, "models": [{"id": "0x" + "ce" * 32,
                                     "template": "damo",
                                     "sp_strategy": "ulysses"}]}, 11),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else str(v))
def test_unported_settings_refused_at_boot(overrides, item):
    """Each setting whose module the port lacks raises BootError naming
    its ROADMAP item (a mesh layout a configured family does not run on
    the port yet, pipeline stages); a setting once refused whose module
    is ported now (item None: a full-width textgen model, in bf16, int8
    and fp8) boots and solves in its mode; the alert engine and the fleet
    worker hooks (item "boots") boot a node with no model. A dp2 mesh
    (item "lanes") boots where the host has the lanes, and is refused at
    boot with the reference's sentence on a host with fewer (here: no
    card and no virtual lanes). robust_video_matting in int8 (item
    "bf16") is refused by the factory with the reference's sentence."""
    from arbius_tpu_torch.node import BootError, load_config

    cfg = load_config(overrides)
    P = _pkg("arbius_tpu_torch")
    eng = P.Engine(P.TokenLedger(), start_time=0)
    if item == "bf16":
        with pytest.raises(P.node.ConfigError, match=(
                "precision mode 'int8' is not shipped for template "
                "robust_video_matting — the matting family serves bf16 "
                "only \\(docs/quantization.md\\)")):
            P.node.build_registry(cfg, device="cpu",
                                  resolve_file=lambda cid: None)
        return
    if item == "lanes":
        from arbius_tpu_torch.parallel import virtual_lanes

        node = P.node.MinerNode(P.node.LocalChain(eng, MINER), cfg,
                                P.node.ModelRegistry())
        with pytest.raises(ValueError, match="needs 2 devices but jax "
                                             "sees 0"):
            node.boot()
        node.close()
        with virtual_lanes(2, "cpu"):
            node = P.node.MinerNode(P.node.LocalChain(eng, MINER), cfg,
                                    P.node.ModelRegistry())
            node.boot()
        assert node.solve_layout == "dp2"
        node.close()
        return
    if item == "boots":
        node = P.node.MinerNode(P.node.LocalChain(eng, MINER), cfg,
                                P.node.ModelRegistry())
        node.boot()
        assert (node.healthwatch is not None) == cfg.alerts.enabled
        node.tick()
        node.close()
        return
    if item is None:
        [m] = cfg.models
        registry = P.node.build_registry(cfg, device="cpu")
        node = P.node.MinerNode(P.node.LocalChain(eng, MINER), cfg, registry)
        node.boot()
        model = registry.get(m.id)
        mode = cfg.precision.mode_for("textgen")
        assert model.runner.pipeline.precision == mode
        assert (model.runner.pipeline.quantized is None) == (mode == "bf16")
        hydrated = model.runner.prepare_hydrated(P.hydrate_input(
            {"prompt": "arbius test cat"}, model.template))
        [(cid, files)] = P.node.solve_cid_batch(
            model, [(hydrated, 1337)], canonical_batch=cfg.canonical_batch)
        assert cid.startswith("0x1220") and set(files) == {"out-1.txt"}
        node.close()
        return
    with pytest.raises(BootError, match=f"ROADMAP queue 1 item {item}\\)"):
        node = P.node.MinerNode(P.node.LocalChain(eng, MINER), cfg,
                                P.node.ModelRegistry())
        node.boot()


def test_pipeline_enabled_boots():
    """The staged pipeline is ported: MiningConfig.example.json's
    `pipeline` block boots, with its encode pool, and closes it."""
    P = _pkg("arbius_tpu_torch")
    eng = P.Engine(P.TokenLedger(), start_time=0)
    node = P.node.MinerNode(P.node.LocalChain(eng, MINER), P.node.load_config(
        {"pipeline": {"enabled": True, "depth": 2, "encode_workers": 2,
                      "max_inflight_pins": 4}}), P.node.ModelRegistry())
    node.boot()
    assert len(node._pipeline._workers) == 2
    node.close()
    assert node._pipeline._workers == []


def test_single_device_mesh_boots():
    P = _pkg("arbius_tpu_torch")
    eng = P.Engine(P.TokenLedger(), start_time=0)
    node = P.node.MinerNode(P.node.LocalChain(eng, MINER),
                            P.node.load_config({"mesh": {"dp": 1}}),
                            P.node.ModelRegistry())
    node.boot()
    assert node.solve_layout == "single"


def test_kandinsky2_boots_with_recorded_golden_and_mines(one_torch_thread):
    """The tiny kandinsky2 model on the CPU (the port's seeded init, bf16
    weights, canonical batch 1): record-golden's function records the
    self-test vector at the template's 768x768 (50 steps, DDIM, guidance
    4.0 by the runner's defaults) for the input and seed of the task the
    node will mine (its taskid taken from a twin world); a node boots
    with it, mines the task on LocalChain through reveal and claim, and
    the on-chain CID is the golden's."""
    from arbius_tpu_torch.cli import record_golden

    P = _pkg("arbius_tpu_torch")
    WAD = P.WAD
    raw = {"prompt": "arbius test cat", "width": 768, "height": 768}

    def world():
        tok = P.TokenLedger()
        eng = P.Engine(tok, start_time=10_000)
        tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
        for a in (MINER, USER):
            tok.mint(a, 1_000 * WAD)
            tok.approve(a, P.Engine.ADDRESS, 10**30)
        mid_b = eng.register_model(USER, MODEL_ADDR, 0, b'{"meta":{}}')
        return tok, eng, mid_b

    def submit(eng, mid_b):
        return "0x" + eng.submit_task(USER, 0, USER, mid_b, WAD,
                                      json.dumps(raw).encode()).hex()

    tid = submit(*world()[1:])
    tok, eng, mid_b = world()
    mid = "0x" + mid_b.hex()

    def config(golden=None):
        return _config(P, canonical_batch=1, models=(P.node.ModelConfig(
            id=mid, template="kandinsky2", tiny=True,
            weights_dtype="bfloat16", golden=golden),))

    model = P.node.build_registry(config(), device="cpu").get(mid)
    rec = record_golden(model, raw, P.taskid2seed(tid), canonical_batch=1,
                        device="cpu")
    chain = P.node.LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    cfg = config(rec["golden"])
    node = P.node.MinerNode(chain, cfg, P.node.build_registry(
        cfg, device="cpu"))
    node.boot()
    assert submit(eng, mid_b) == tid
    while node.tick():
        pass
    bal0 = tok.balance_of(MINER)
    eng.advance_time(2000 + 121)
    while node.tick():
        pass
    sol = eng.solutions[bytes.fromhex(tid[2:])]
    assert sol.claimed and "0x" + sol.cid.hex() == rec["golden"]["cid"]
    assert tok.balance_of(MINER) - bal0 == WAD * 9 // 10


@pytest.mark.parametrize("overrides,item", [
    ({"model": {"checkpoint": "/ckpts/kandinsky2"}}, "missing file"),
    ({"model": {"tokenizer": "clip_bpe", "vocab_path": "vocab.json",
                "merges_path": "merges.txt"}}, "missing file"),
    ({"model": {"tokenizer": "clip_bpe", "merges_path": "merges.txt"}},
     "no vocab_path"),
    ({"precision": {"default": "int8"}}, None),
    ({"precision": {"templates": {"kandinsky2": "fp8"}}}, None),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else str(v))
def test_registry_refuses_kandinsky2_unported_settings(overrides, item):
    """Checkpoints and the CLIP BPE tokenizer are ported: a config naming
    a checkpoint or a vocabulary file that is not there fails loudly at
    boot, and a clip_bpe model with no vocab_path at load; int8 and fp8
    (item None) build, with the weights held quantized."""
    P = _pkg("arbius_tpu_torch")
    model = {"id": "0x" + "00" * 32, "template": "kandinsky2", "tiny": True,
             **overrides.get("model", {})}
    raw = {"compile_cache_dir": None, "models": [model],
           **{k: v for k, v in overrides.items() if k != "model"}}
    if item == "no vocab_path":
        with pytest.raises(P.node.ConfigError, match="vocab_path"):
            P.node.load_config(raw)
        return
    cfg = P.node.load_config(raw)
    if item == "missing file":
        with pytest.raises((P.node.ConfigError, FileNotFoundError),
                           match="not a file|vocab.json"):
            P.node.build_registry(cfg, device="cpu")
        return
    pipe = P.node.build_registry(cfg, device="cpu").get(
        model["id"]).runner.pipeline
    mode = cfg.precision.mode_for("kandinsky2")
    assert pipe.precision == mode and pipe.quantized.leaves
    assert pipe.bucket_tag(4, 768, 768, 50, "DDIM").endswith(f".{mode}")


@pytest.mark.parametrize("template,mesh,item", [
    ("zeroscopev2xl", {"sp": 2}, 11), ("damo", {"dp": 2, "sp": 2}, 11),
    ("robust_video_matting", None, None)])
def test_registry_refuses_unported_templates(template, mesh, item):
    """The video templates build on one device only (their frame-axis
    sequence parallelism, ring or ulysses, waits for multi-device);
    robust_video_matting (item None) builds, given a file resolver."""
    P = _pkg("arbius_tpu_torch")
    mid = "0x" + "00" * 32
    cfg = _config(P, mesh=mesh, models=(P.node.ModelConfig(
        id=mid, template=template, tiny=True),))
    if item is None:
        reg = P.node.build_registry(cfg, device="cpu",
                                    resolve_file=lambda cid: None)
        assert type(reg.get(mid).runner).__name__ == "RVMRunner"
        return
    with pytest.raises(P.node.ConfigError, match=f"item {item}\\)"):
        P.node.build_registry(cfg, device="cpu")


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    w = build_world(_pkg("arbius_tpu_torch"), profile_dir=str(tmp_path),
                    profile_every=1)
    submit(w)
    drain(w.node)
    [trace] = tmp_path.glob("solve-*.json")
    assert json.loads(trace.read_text())["traceEvents"]


def test_demo_mine_without_jax():
    """`demo-mine --device cpu --tiny` mines and claims a task in a
    process where jax, jaxlib, flax and arbius_tpu cannot be imported."""
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'arbius_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from arbius_tpu_torch.cli import main\n"
        "sys.exit(main(['demo-mine', '--device', 'cpu', '--tiny']))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "claimed: True" in out.stdout
    assert "cid 0x1220" in out.stdout
