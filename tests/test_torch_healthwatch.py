"""The port's alert engine (arbius_tpu_torch/obs/healthwatch.py, a renamed
copy of the reference's) on the CPU: the twins of tests/test_healthwatch.py
(the state machine's hysteresis edges, the rule catalog and its config,
the engine over a fake node, the gauges and the ALERTS block, and
/debug/alerts with the journal's filters on the port's MinerNode and
ControlRPC); the same tick history through both packages' engines with
equal transition journals and gauges; and a tiny anythingv3 mining
through the port's MinerNode to the same CIDs with alerts on and off.
The offline tools (tools/healthwatch.py, tools/benchkeeper.py) are the
reference's and stay its own tests'. SIM113 and the simnet CID pins are
in tests/test_torch_sim.py."""
from __future__ import annotations

import importlib
import json
import pathlib
import types
import urllib.request

import pytest

from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
from arbius_tpu_torch.node import (
    LocalChain,
    MinerNode,
    MiningConfig,
    ModelConfig,
    ModelRegistry,
    RegisteredModel,
)
from arbius_tpu_torch.node.config import AlertsConfig, ConfigError
from arbius_tpu_torch.obs import Obs
from arbius_tpu_torch.obs.healthwatch import (
    RULE_NAMES,
    AlertRule,
    AlertStateMachine,
    HealthWatch,
    default_catalog,
)
from arbius_tpu_torch.templates.engine import load_template

REPO = pathlib.Path(__file__).resolve().parent.parent
MINER = "0x" + "aa" * 20
USER = "0x" + "01" * 20


def _machine(for_ticks: int, resolve_ticks: int = 1) -> AlertStateMachine:
    return AlertStateMachine(
        AlertRule(name="t", summary="t", signal="t",
                  for_ticks=for_ticks),
        resolve_ticks=resolve_ticks)


def _walk(m: AlertStateMachine, actives) -> list:
    out = []
    for i, active in enumerate(actives):
        change = m.step(bool(active), now=i)
        if change is not None:
            out.append(change)
    return out


# -- the state machine's hysteresis edges -----------------------------------

@pytest.mark.parametrize("for_ticks,resolve_ticks,actives,changes", [
    # active for for_ticks - 1 evaluations, then clear: never fires
    (3, 1, [1, 1, 0, 0], [("ok", "pending"), ("pending", "ok")]),
    # a sustained breach fires once, not once per active evaluation
    (3, 1, [1] * 6, [("ok", "pending"), ("pending", "firing")]),
    # resolve_ticks = 2: resolved -> ok waits two quiet evaluations
    (1, 2, [1, 0, 0, 0], [("ok", "firing"), ("firing", "resolved"),
                          ("resolved", "ok")]),
    # a flapping series: one transition per state change
    (1, 1, [1, 0, 1, 0, 1], [("ok", "firing"), ("firing", "resolved"),
                             ("resolved", "firing"), ("firing", "resolved"),
                             ("resolved", "firing")]),
    # a resolved alert re-arms through pending: one blip does not re-fire
    (2, 1, [1, 1, 0, 1, 0, 0], [("ok", "pending"), ("pending", "firing"),
                                ("firing", "resolved"),
                                ("resolved", "pending"), ("pending", "ok")]),
], ids=["never_fires", "fires_once", "resolves_to_ok", "flapping",
        "rearms_through_pending"])
def test_state_machine_edges(for_ticks, resolve_ticks, actives, changes):
    m = _machine(for_ticks, resolve_ticks)
    got = _walk(m, actives)
    assert got == changes
    state = "ok"
    for old, new in got:
        assert old == state and new != old
        state = new
    assert m.state == state


# -- catalog / config plumbing ----------------------------------------------

def test_rule_names_match_default_catalog_and_config():
    """The catalog's names are RULE_NAMES, the tuple the port's config
    validates `alerts.per_rule` against (it has no copy of its own), and
    the reference's."""
    from arbius_tpu.obs import healthwatch as ref_healthwatch
    from arbius_tpu_torch.node import config

    names = tuple(r.name for r in default_catalog(AlertsConfig()))
    assert names == RULE_NAMES == ref_healthwatch.RULE_NAMES
    assert len(set(names)) == len(names)
    assert not hasattr(config, "RULE_NAMES")


def test_per_rule_override_reaches_the_machine():
    cfg = AlertsConfig(per_rule={"rpc_degraded": 7})
    by_name = {r.name: r for r in default_catalog(cfg)}
    assert by_name["rpc_degraded"].for_ticks == 7
    assert by_name["pin_degraded"].for_ticks == cfg.for_ticks


@pytest.mark.parametrize("kwargs,match", [
    ({"per_rule": {"not_a_rule": 2}}, "unknown rule"),
    ({"for_ticks": 0}, "for_ticks"),
    ({"per_rule": {"rpc_degraded": 0}}, "per_rule"),
    ({"stall_burst": 0}, "stall_burst"),
])
def test_alerts_config_validation_one_sentence_errors(kwargs, match):
    with pytest.raises(ConfigError, match=match):
        AlertsConfig(**kwargs)


def test_load_config_alerts_block():
    from arbius_tpu_torch.node.config import load_config

    with pytest.raises(ConfigError, match="alerts"):
        load_config('{"alerts": {"bogus_knob": 1}}')
    cfg = load_config('{"alerts": {"enabled": true, '
                      '"per_rule": {"stuck_tick": 2}}}')
    assert cfg.alerts.enabled
    example = load_config((REPO / "MiningConfig.example.json").read_text())
    assert example.alerts.enabled is False
    assert example.alerts.for_ticks == 3 and example.alerts.per_rule == {}


# -- the engine over a fake node --------------------------------------------

class _FakeNode:
    def __init__(self, obs):
        self.obs = obs
        self.chain = types.SimpleNamespace(now=0)
        self.db = types.SimpleNamespace(due=[])
        self.db.get_jobs = lambda now, limit=None: self.db.due[:limit]
        self.task_feed = None


def _watch(obs_cls=Obs, watch_cls=HealthWatch, cfg_cls=AlertsConfig,
           recovered=False, slo=None, **cfg):
    obs = obs_cls()
    hw = watch_cls(obs, cfg_cls(enabled=True, **cfg), slo=slo,
                   recovered=recovered)
    return obs, hw, _FakeNode(obs)


def test_quarantine_rule_fires_on_counter_delta():
    obs, hw, node = _watch()
    c = obs.registry.counter("arbius_jobs_failed_total",
                             labelnames=("method",))
    hw.evaluate(node)
    assert hw.states()["job_quarantine"] == "ok"
    c.inc(method="solve")
    node.chain.now = 5
    hw.evaluate(node)
    assert hw.states()["job_quarantine"] == "firing"   # for_ticks=1
    node.chain.now = 10
    hw.evaluate(node)                                  # no new failures
    assert hw.states()["job_quarantine"] == "resolved"
    trans = obs.journal.events(kind="alert_transition")
    assert [(e["prev"], e["state"]) for e in trans] == \
        [("ok", "firing"), ("firing", "resolved")]
    assert obs.registry.counter(
        "arbius_alert_transitions_total",
        labelnames=("alert",)).value(alert="job_quarantine") == 2


def test_stuck_tick_watchdog_uses_chain_time_only():
    obs, hw, node = _watch(stuck_after_seconds=10)
    node.db.due = [object()]
    hw.evaluate(node, 0)                 # t=0: anchors progress
    node.chain.now = 8
    hw.evaluate(node, 0)
    assert hw.states()["stuck_tick"] == "ok"
    node.chain.now = 20                  # 20s with due jobs, no work
    hw.evaluate(node, 0)
    assert hw.states()["stuck_tick"] == "firing"
    node.chain.now = 25
    hw.evaluate(node, 3)                 # progress: jobs processed
    assert hw.states()["stuck_tick"] == "resolved"


def test_unprofitable_streak_needs_consecutive_ticks():
    obs, hw, node = _watch(unprofitable_streak=3)
    c = obs.registry.counter("arbius_tasks_unprofitable_total",
                             labelnames=("model",))
    for now in (1, 2):
        c.inc(model="0xm")
        node.chain.now = now
        hw.evaluate(node)
    assert hw.states()["unprofitable_streak"] == "pending"
    node.chain.now = 3
    hw.evaluate(node)                    # a tick with no rejects
    assert hw.states()["unprofitable_streak"] == "ok"
    for now in (4, 5, 6):
        c.inc(model="0xm")
        node.chain.now = now
        hw.evaluate(node)
    assert hw.states()["unprofitable_streak"] == "firing"


def test_pipeline_stall_is_a_storm_threshold_not_backpressure():
    obs, hw, node = _watch(stall_burst=4, for_ticks=1)
    c = obs.registry.counter("arbius_pipeline_stalls_total",
                             labelnames=("stage",))
    c.inc(stage="encode")                # routine backpressure
    hw.evaluate(node)
    assert hw.states()["pipeline_stall"] == "ok"
    c.inc(4, stage="network")            # a storm in one tick
    node.chain.now = 5
    hw.evaluate(node)
    assert hw.states()["pipeline_stall"] == "firing"


def test_crash_recovered_holds_then_resolves():
    obs, hw, node = _watch(crash_hold_ticks=2, recovered=True)
    hw.evaluate(node)
    assert hw.states()["crash_recovered"] == "firing"
    node.chain.now = 5
    hw.evaluate(node)
    assert hw.states()["crash_recovered"] == "firing"
    node.chain.now = 10
    hw.evaluate(node)                    # hold expired
    assert hw.states()["crash_recovered"] == "resolved"


def test_slo_rules_use_bucket_estimates():
    from arbius_tpu_torch.node.config import SLOConfig
    from arbius_tpu_torch.obs.registry import CHAIN_SECONDS_BUCKETS

    obs, hw, node = _watch(slo=SLOConfig(queue_wait_p95=10.0), for_ticks=1)
    h = obs.registry.histogram("arbius_fleet_queue_wait_seconds",
                               buckets=CHAIN_SECONDS_BUCKETS)
    for _ in range(20):
        h.observe(2.0)
    hw.evaluate(node)
    assert hw.states()["slo_queue_wait"] == "ok"
    for _ in range(80):
        h.observe(500.0)                 # p95 now far above 10s
    node.chain.now = 5
    hw.evaluate(node)
    assert hw.states()["slo_queue_wait"] == "firing"
    assert hw.states()["slo_time_to_commit"] == "ok"   # not declared


def test_unported_sources_keep_their_rules_ok():
    """perf_drift and aot_reject_storm read perfscope and the AOT cache,
    which the port lacks: the rules stay in the catalog and stay ok, as
    the reference's do with both off."""
    obs, hw, node = _watch(for_ticks=1)
    assert getattr(obs, "perfscope", None) is None
    for now in range(1, 5):
        node.chain.now = now
        hw.evaluate(node)
    states = hw.states()
    assert states["perf_drift"] == states["aot_reject_storm"] == "ok"


def test_evaluate_never_raises(monkeypatch):
    obs, hw, node = _watch()
    monkeypatch.setattr(hw, "_signals",
                        lambda *a: (_ for _ in ()).throw(RuntimeError()))
    hw.evaluate(node)                    # must not propagate
    assert [e["kind"] for e in obs.journal.events(
        kind="healthwatch_skip")] == ["healthwatch_skip"]


def test_alert_gauges_render_states_and_prometheus_alerts_block():
    obs, hw, node = _watch()
    obs.registry.counter("arbius_jobs_failed_total",
                         labelnames=("method",)).inc(method="solve")
    hw.evaluate(node)
    text = obs.registry.render()
    assert 'arbius_alert_state{alert="job_quarantine"} 2' in text
    assert 'arbius_alert_state{alert="stuck_tick"} 0' in text
    assert ('ALERTS{alertname="job_quarantine",alertstate="firing"} 1'
            in text)
    for name in RULE_NAMES:
        assert f'arbius_alert_state{{alert="{name}"}}' in text


# -- the same tick history through both packages' engines --------------------

def _history(pkg: str) -> tuple[list[dict], str, dict]:
    """Drive one package's engine over a fake node through a scripted
    history that walks most of the catalog (failed jobs, retries on the
    chain and the pinner, a stall storm, unprofitable ticks, a stuck
    queue, a recovered boot, a queue-wait SLO breach); return the
    transition journal without its wall clock, the rendered registry and
    the final states."""
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    config, registry = mod("node.config"), mod("obs.registry")
    obs, hw, node = _watch(
        mod("obs").Obs, mod("obs.healthwatch").HealthWatch,
        config.AlertsConfig, recovered=True,
        slo=config.SLOConfig(queue_wait_p95=10.0), for_ticks=2,
        stuck_after_seconds=30, stall_burst=3, unprofitable_streak=2,
        per_rule={"rpc_degraded": 1})
    reg = obs.registry
    failed = reg.counter("arbius_jobs_failed_total", labelnames=("method",))
    retries = reg.counter("arbius_retry_attempts_total",
                          labelnames=("op",))
    stalls = reg.counter("arbius_pipeline_stalls_total",
                         labelnames=("stage",))
    unprofitable = reg.counter("arbius_tasks_unprofitable_total",
                               labelnames=("model",))
    wait = reg.histogram("arbius_fleet_queue_wait_seconds",
                         buckets=registry.CHAIN_SECONDS_BUCKETS)
    for tick in range(24):
        node.chain.now = 100 + 7 * tick
        if tick in (2, 3, 4):
            failed.inc(method="solve")
        if tick in (3, 4, 5, 9):
            retries.inc(op="signalCommitment")
        if tick in (6, 7, 8):
            retries.inc(2, op="pin_files")
        if tick in (8, 9, 15):
            stalls.inc(3, stage="network")
        if 10 <= tick < 14:
            unprofitable.inc(model="0xm")
        node.db.due = [object()] if 12 <= tick < 20 else []
        wait.observe(2.0 if tick < 16 else 900.0)
        hw.evaluate(node, 0 if 12 <= tick < 20 else 1)
    journal = [{k: v for k, v in e.items() if k != "wall"}
               for e in obs.journal.events(kind="alert_transition")]
    return journal, reg.render(), hw.states()


def test_same_history_same_transitions_and_gauges_as_reference():
    ours, theirs = _history("arbius_tpu_torch"), _history("arbius_tpu")
    assert ours[0] == theirs[0] and len(ours[0]) > 10
    assert ours[1] == theirs[1]
    assert ours[2] == theirs[2]
    walked = {e["alert"] for e in ours[0]}
    assert {"job_quarantine", "rpc_degraded", "pin_degraded",
            "pipeline_stall", "unprofitable_streak", "stuck_tick",
            "crash_recovered", "slo_queue_wait"} <= walked
    assert ours[2]["slo_queue_wait"] == "firing"
    assert {e["state"] for e in ours[0]} == {"pending", "firing",
                                             "resolved", "ok"}


# -- the port's node and control RPC ----------------------------------------

def _fake_runner(hydrated: dict, seed: int) -> dict:
    blob = json.dumps({k: v for k, v in sorted(hydrated.items())
                       if k != "seed"}).encode() + seed.to_bytes(8, "big")
    return {"out-1.png": b"\x89PNG" + blob}


def _node_world(runner=_fake_runner, **cfg):
    """The port's Engine + LocalChain + MinerNode, the miner staked, one
    anythingv3 model served by `runner`. Returns the engine, the node
    and the model id."""
    tok = TokenLedger()
    eng = Engine(tok, start_time=10_000)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, Engine.ADDRESS, 10**30)
    mid = "0x" + eng.register_model(USER, USER, 0,
                                    b'{"meta":{"title":"t"}}').hex()
    registry = ModelRegistry()
    registry.register(RegisteredModel(
        id=mid, template=load_template("anythingv3"), runner=runner))
    chain = LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    node = MinerNode(chain, MiningConfig(
        compile_cache_dir=None,
        models=(ModelConfig(id=mid, template="anythingv3"),), **cfg),
        registry)
    return eng, node, mid


def _drain(node, n=10):
    for _ in range(n):
        if node.tick() == 0:
            break


def _submit(eng, mid, raw, fee=0):
    return "0x" + eng.submit_task(
        USER, 0, USER, bytes.fromhex(mid[2:]), fee,
        json.dumps(raw).encode()).hex()


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return json.loads(r.read().decode())


@pytest.fixture()
def alert_world():
    from arbius_tpu_torch.node.rpc import ControlRPC

    eng, node, mid = _node_world(alerts=AlertsConfig(enabled=True))
    node.boot()
    _drain(node)
    rpc = ControlRPC(node)
    rpc.start()
    yield eng, node, mid, rpc
    rpc.stop()
    node.close()


def test_debug_alerts_endpoint_and_journal_filters(alert_world):
    eng, node, _, rpc = alert_world
    doc = _get(rpc.port, "/debug/alerts")
    assert doc["enabled"] is True
    assert [a["alert"] for a in doc["alerts"]] == sorted(RULE_NAMES)
    assert all(a["state"] == "ok" for a in doc["alerts"])

    # a flap: job_quarantine fires, resolves, returns to ok
    node.obs.registry.counter("arbius_jobs_failed_total",
                              labelnames=("method",)).inc(method="x")
    node.tick()
    doc = _get(rpc.port, "/debug/alerts")
    by_name = {a["alert"]: a for a in doc["alerts"]}
    assert by_name["job_quarantine"]["state"] == "firing"
    assert by_name["job_quarantine"]["transitions"] == 1
    for _ in range(2):
        eng.advance_time(5)
        node.tick()

    doc = _get(rpc.port, "/debug/journal?kind=alert_transition")
    events = doc["events"]
    assert [(e["prev"], e["state"]) for e in events] == \
        [("ok", "firing"), ("firing", "resolved"), ("resolved", "ok")]
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    # kind + limit compose: limit keeps the newest events post-filter
    doc = _get(rpc.port, "/debug/journal?kind=alert_transition&limit=1")
    assert [(e["prev"], e["state"]) for e in doc["events"]] == \
        [("resolved", "ok")]


def test_debug_journal_taskid_filter_mirrors_trace_semantics(alert_world):
    eng, node, mid, rpc = alert_world
    tid = _submit(eng, mid, {"prompt": "a cat", "negative_prompt": ""},
                  fee=10 * WAD)
    _drain(node)
    events = _get(rpc.port, f"/debug/journal?taskid={tid}")["events"]
    assert events, "the task's lifecycle journaled nothing"
    assert all(e.get("taskid") == tid or tid in (e.get("taskids") or ())
               for e in events)
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    assert events == node.obs.journal.events(taskid=tid, limit=200)
    assert _get(rpc.port, "/debug/journal?taskid=0x" + "ab" * 32
                )["events"] == []


def test_alerts_off_reports_disabled():
    from arbius_tpu_torch.node.rpc import ControlRPC

    _, node, _ = _node_world()
    node.boot()
    assert node.healthwatch is None
    rpc = ControlRPC(node)
    rpc.start()
    try:
        assert _get(rpc.port, "/debug/alerts")["enabled"] is False
    finally:
        rpc.stop()
        node.close()


@pytest.fixture(scope="module")
def one_torch_thread():
    """The tiny model's small torch ops on one thread: with the suite's
    workers sharing the host's cores, torch's per-op thread pool
    otherwise waits on oversubscribed cores at every small op."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(one_torch_thread):
    from arbius_tpu_torch.node import build_registry

    mid = "0x" + "00" * 32
    cfg = MiningConfig(compile_cache_dir=None, models=(
        ModelConfig(id=mid, template="anythingv3", tiny=True),))
    return build_registry(cfg, device="cpu").get(mid)


def test_tiny_anythingv3_same_cids_alerts_on_and_off(tiny):
    """The alert engine is bookkeeping only: the tiny anythingv3 mines
    the same tasks through the port's MinerNode to the same on-chain
    CIDs with alerts on and off, and a clean mine fires no alert."""
    cids = {}
    for on in (False, True):
        eng, node, mid = _node_world(tiny.runner, canonical_batch=2,
                                     alerts=AlertsConfig(enabled=on))
        node.boot(skip_self_test=True)
        tids = [_submit(eng, mid, {
            "prompt": f"a lighthouse, study {i}", "negative_prompt": "",
            "width": 128, "height": 128, "num_inference_steps": 2})
            for i in range(3)]
        _drain(node)
        cids[on] = ["0x" + eng.solutions[bytes.fromhex(t[2:])].cid.hex()
                    for t in tids]
        if on:
            assert set(node.healthwatch.states().values()) == {"ok"}
            assert not node.obs.journal.events(kind="alert_transition")
        node.close()
    assert cids[True] == cids[False] and len(set(cids[True])) == 3
