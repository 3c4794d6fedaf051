"""The port's staged solve executor (arbius_tpu_torch/node/pipeline.py)
against the reference's, on the CPU.

Differential scenarios: the cases of tests/test_pipeline.py that need no
simnet run in both packages (`Engine` + `LocalChain` + `MinerNode` with
`pipeline.enabled`) with the same fake runners. Each case holds the
scenario's own checks in one package and requires what it records (the
chain's event sequence, CIDs, pinned bytes, the runner's schedule,
journal stages, checkpoint rows) to equal a run of the reference's.

The load-bearing property is byte equality: CIDs, pinned files and the
sequence of chain writes are identical with the pipeline on and off, for
dispatch/finalize runners and plain callables, at canonical batch 1 and
4, and for the tiny anythingv3 (float32, seeded init) on the CPU. Crash
resume: a task whose checkpoint holds its CID skips the pin that already
landed; a lost batch window re-derives it with the same bytes. The
buffers are bounded: the encode queue at `depth`, the network backlog at
`max_inflight_pins` past each consumed chunk.
"""
from __future__ import annotations

import functools
import importlib
import json
import pathlib
import threading
import types

import pytest

PACKAGES = ("arbius_tpu", "arbius_tpu_torch")
MINER = "0x" + "aa" * 20
USER = "0x" + "01" * 20
MODEL_ADDR = "0x" + "33" * 20


@functools.cache
def _pkg(name: str) -> types.SimpleNamespace:
    chain = importlib.import_module(f"{name}.chain")
    cid = importlib.import_module(f"{name}.l0.cid")
    node = importlib.import_module(f"{name}.node")
    return types.SimpleNamespace(
        name=name, Engine=chain.Engine, TokenLedger=chain.TokenLedger,
        WAD=chain.WAD, node=node,
        config=importlib.import_module(f"{name}.node.config"),
        pipeline=importlib.import_module(f"{name}.node.pipeline"),
        load_template=importlib.import_module(
            f"{name}.templates.engine").load_template,
        cid_hex=cid.cid_hex, cid_of=cid.cid_of_solution_files,
        dag_of_file=cid.dag_of_file)


def pipe_on(P, **kw):
    args = {"enabled": True, "depth": 2, "encode_workers": 2,
            "max_inflight_pins": 2, **kw}
    return P.config.PipelineConfig(**args)


class RecordingPinner:
    """Captures the exact bytes every task pinned (the byte-equality
    oracle) while answering like a well-behaved service."""

    def __init__(self, P):
        self.P = P
        self.pinned: dict[str, dict] = {}
        self.calls = 0

    def pin_files(self, files: dict, taskid: str = "") -> bytes:
        self.calls += 1
        self.pinned[taskid] = dict(files)
        return self.P.cid_of(files)

    def pin_blob(self, content: bytes, filename: str = "input") -> bytes:
        return self.P.dag_of_file(content).cid


class SD15Fake:
    """SD15Runner-shaped: dispatch/finalize split, run_batch, callable;
    deterministic bytes from (input, seed); logs the schedule."""

    def __init__(self, log=None):
        self.log = log if log is not None else []

    def __call__(self, hydrated, seed):
        return self.finalize(self.dispatch([(hydrated, seed)]), 1)[0]

    def run_batch(self, items):
        return self.finalize(self.dispatch(items), len(items))

    def dispatch(self, items):
        self.log.append(("dispatch", len(items)))
        return [self._bytes(h, s) for h, s in items]

    def finalize(self, dev, n_real):
        self.log.append(("finalize", n_real))
        return [{"out-1.png": dev[i]} for i in range(n_real)]

    @staticmethod
    def _bytes(hydrated, seed):
        blob = json.dumps({k: v for k, v in sorted(hydrated.items())
                           if k != "seed"}).encode()
        return b"\x89PNG" + blob + seed.to_bytes(8, "big")


class PlainFake:
    """A plain callable with no batch or dispatch surface."""

    def __call__(self, hydrated, seed):
        blob = json.dumps({k: v for k, v in sorted(hydrated.items())
                           if k != "seed"}).encode()
        return {"out-1.png": b"\x00\x00\x00 ftypisom" + blob}


def new_chain(P):
    """A funded engine with one registered model: (engine, model id)."""
    WAD = P.WAD
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, P.Engine.ADDRESS, 10**30)
    return eng, "0x" + eng.register_model(USER, MODEL_ADDR, 0,
                                          b'{"meta":{}}').hex()


def world(P, runner, *, pipeline=None, canonical_batch=1, db_path=":memory:",
          eng=None, mid=None, stake=True):
    """(engine, node, model id, pinner): a funded LocalChain world whose
    node mines `runner`'s output; pass `eng`/`mid` to boot another life
    over the same chain."""
    if eng is None:
        eng, mid = new_chain(P)
    registry = P.node.ModelRegistry()
    registry.register(P.node.RegisteredModel(
        id=mid, template=P.load_template("anythingv3"), runner=runner))
    chain = P.node.LocalChain(eng, MINER)
    if stake:
        chain.validator_deposit(100 * P.WAD)
    cfg = P.node.MiningConfig(
        compile_cache_dir=None, db_path=db_path,
        models=(P.node.ModelConfig(id=mid, template="anythingv3"),),
        canonical_batch=canonical_batch,
        pipeline=pipeline or P.config.PipelineConfig())
    pinner = RecordingPinner(P)
    node = P.node.MinerNode(chain, cfg, registry, pinner=pinner)
    node.boot()
    drain(node)
    return eng, node, mid, pinner


def drain(node, n=10):
    total = 0
    for _ in range(n):
        done = node.tick()
        total += done
        if done == 0:
            break
    return total


def submit(eng, mid, prompt="a cat"):
    return "0x" + eng.submit_task(
        USER, 0, USER, bytes.fromhex(mid[2:]), 0,
        json.dumps({"prompt": prompt, "negative_prompt": ""}).encode()).hex()


def chain_writes(eng) -> list:
    """The engine's event sequence: every chain write, in order."""
    return [(e.name, {k: v.hex() if isinstance(v, bytes) else v
                      for k, v in sorted(e.args.items())})
            for e in eng.events]


def mine(P, runner_cls, *, pipeline, canonical_batch, n_tasks=5):
    """{taskid: (cid, pinned files)} and the chain writes of one world."""
    eng, node, mid, pinner = world(P, runner_cls(), pipeline=pipeline,
                                   canonical_batch=canonical_batch)
    tids = [submit(eng, mid, prompt=f"task {i}") for i in range(n_tasks)]
    drain(node)
    out = {}
    for tid in tids:
        sol = eng.solutions[bytes.fromhex(tid[2:])]
        out[tid] = ("0x" + sol.cid.hex(), pinner.pinned.get(tid))
    node.close()
    return out, chain_writes(eng)


# -- scenarios (tests/test_pipeline.py) -------------------------------------

def _on_vs_off(runner_cls, batch):
    def scenario(P):
        off, writes_off = mine(P, runner_cls, pipeline=None,
                               canonical_batch=batch)
        on, writes_on = mine(P, runner_cls, pipeline=pipe_on(P),
                             canonical_batch=batch)
        assert on == off
        assert writes_on == writes_off
        for cid, files in on.values():
            assert cid == P.cid_hex(P.cid_of(files))
        return {"mined": on, "writes": writes_on}
    return scenario


def sc_inline_encode(P):
    """encode_workers=0: everything on the tick thread; same bytes."""
    inline = pipe_on(P, depth=3, encode_workers=0, max_inflight_pins=1)
    off, writes_off = mine(P, SD15Fake, pipeline=None, canonical_batch=4)
    on, writes_on = mine(P, SD15Fake, pipeline=inline, canonical_batch=4)
    assert (on, writes_on) == (off, writes_off)
    return {"mined": on, "writes": writes_on}


def sc_depth_k_prefetch(P):
    log = []
    eng, node, mid, _ = world(P, SD15Fake(log), canonical_batch=2,
                              pipeline=pipe_on(P, encode_workers=0,
                                               max_inflight_pins=8))
    for i in range(6):
        submit(eng, mid, prompt=f"t{i}")
    log.clear()
    drain(node)
    kinds = [k for k, _ in log]
    # 3 chunks, window 2: the second dispatch precedes the first finalize
    assert kinds == ["dispatch", "dispatch", "finalize", "dispatch",
                     "finalize", "finalize"]
    node.close()
    return {"log": log}


def sc_stage_events_monotonic(P):
    eng, node, mid, _ = world(P, SD15Fake(), canonical_batch=2,
                              pipeline=pipe_on(P))
    tids = [submit(eng, mid, prompt=f"t{i}") for i in range(4)]
    drain(node)
    out = {}
    for tid in tids:
        evs = node.obs.journal.events(kind="pipeline_stage", taskid=tid)
        stages = [e["stage"] for e in evs]
        assert stages == ["solve", "encode", "pin", "commit", "reveal"]
        ranks = [P.pipeline.STAGE_RANK[s] for s in stages]
        assert ranks == sorted(ranks)
        out[tid] = stages
    node.close()
    return {"stages": out}


def sc_metrics_moving(P):
    eng, node, mid, _ = world(P, SD15Fake(), canonical_batch=2,
                              pipeline=pipe_on(P))
    for i in range(4):
        submit(eng, mid, prompt=f"t{i}")
    drain(node)
    reg = node.obs.registry
    h = reg.histogram("arbius_pipeline_stage_seconds", labelnames=("stage",))
    counts = {s: h.count(stage=s) for s in ("device", "encode", "network")}
    assert counts == {"device": 2, "encode": 2, "network": 4}
    # the infer signal keeps the serial path's granularity: one sample
    # per bucket
    assert len(node.metrics.stage_seconds["infer"]) == 1
    assert reg.counter("arbius_chip_idle_seconds_total").value() >= 0.0
    node.close()
    return {"counts": counts}


def sc_tick_one_commit(P):
    """A tick is one sqlite commit, pipeline or not."""
    eng, node, mid, _ = world(P, SD15Fake(), canonical_batch=1)
    reg = node.obs.registry
    for i in range(4):
        submit(eng, mid, prompt=f"t{i}")
    c = reg.counter("arbius_db_commits_total")
    before = c.value()
    assert node.tick() == 4
    assert c.value() - before == 1
    node.close()
    return {}


def sc_chunk_failure(P):
    class Flaky(SD15Fake):
        def dispatch(self, items):
            if any(h["prompt"] == "boom" for h, _ in items):
                raise RuntimeError("chunk exploded")
            return super().dispatch(items)

    eng, node, mid, _ = world(P, Flaky(), canonical_batch=1,
                              pipeline=pipe_on(P))
    good = [submit(eng, mid, prompt=f"ok {i}") for i in range(2)]
    bad = submit(eng, mid, prompt="boom")
    drain(node)
    for tid in good:
        assert bytes.fromhex(tid[2:]) in eng.solutions
    assert bytes.fromhex(bad[2:]) not in eng.solutions
    failed = node.db.failed_jobs()
    assert ("solve", {"taskid": bad, "model": mid}) in failed
    node.close()
    return {"failed": failed, "writes": chain_writes(eng)}


def sc_worker_death(P):
    """A BaseException in a worker's finalize surfaces as a quarantined
    chunk instead of wedging the tick thread."""
    class Dying(SD15Fake):
        def finalize(self, dev, n_real):
            raise KeyboardInterrupt("worker killed")

    eng, node, mid, _ = world(P, Dying(), canonical_batch=2,
                              pipeline=pipe_on(P))
    tids = [submit(eng, mid, prompt=f"t{i}") for i in range(2)]
    drain(node)
    failed = {d.get("taskid") for m, d in node.db.failed_jobs()
              if m == "solve"}
    assert failed == set(tids)
    node.close()
    return {"failed": sorted(failed)}


def sc_bounded_buffers(P):
    """The device->encode queue holds at most `depth` chunks, and after
    each consumed chunk the network backlog is drained to
    `max_inflight_pins` (the stall counter counts each forced drain): at
    no point of the journal are more than max_inflight_pins + one
    chunk's tasks encoded and not yet pinned."""
    cfg = pipe_on(P, depth=2, encode_workers=2, max_inflight_pins=1)
    eng, node, mid, _ = world(P, SD15Fake(), canonical_batch=2,
                              pipeline=cfg)
    assert node._pipeline._encode_q.maxsize == cfg.depth
    for i in range(6):
        submit(eng, mid, prompt=f"t{i}")
    drain(node)
    waiting = peak = 0
    for ev in node.obs.journal.events(kind="pipeline_stage"):
        waiting += {"encode": 1, "pin": -1}.get(ev["stage"], 0)
        peak = max(peak, waiting)
    assert waiting == 0 and 1 <= peak <= cfg.max_inflight_pins + 2
    stalls = node.obs.registry.counter(
        "arbius_pipeline_stalls_total", labelnames=("stage",))
    network = stalls.value(stage="network")
    assert network >= 1
    assert len(eng.solutions) == 6
    node.close()
    return {"peak": peak, "network_stalls": network}


def _crash_world(P, tmp_path):
    """A durable-checkpoint world: boot lives of one node over
    one chain and one sqlite file, the staged pipeline on."""
    db_path = str(tmp_path / f"{P.name}.sqlite")
    eng, mid = new_chain(P)
    P.node.LocalChain(eng, MINER).validator_deposit(100 * P.WAD)

    def spawn():
        return world(P, SD15Fake(), pipeline=pipe_on(P), db_path=db_path,
                     eng=eng, mid=mid, stake=False)[1:]

    return eng, mid, spawn


def sc_resume_recorded_pin(P, tmp_path):
    """A pin the checkpoint durably recorded before a crash is not re-run
    by the next life: a foreign (ControlRPC-class) thread writes mid-tick,
    which makes the window so far durable, then the commit dies."""
    eng, mid, spawn = _crash_world(P, tmp_path)
    node, _, p1 = spawn()
    tid = submit(eng, mid)

    def flush_then_die(_commitment):
        t = threading.Thread(target=lambda: node.db.queue_job(
            "voteFinish", {"taskid": "0xflush"}, waituntil=2**50))
        t.start()
        t.join()
        raise KeyboardInterrupt("sim kill")

    node.chain.signal_commitment = flush_then_die
    with pytest.raises(KeyboardInterrupt):
        drain(node)
    assert p1.calls == 1
    state = node.db.get_pipeline_stage(tid)
    assert state == ("pin", P.cid_hex(P.cid_of(p1.pinned[tid])))
    node.close()

    node2, _, p2 = spawn()
    drain(node2)
    assert p2.calls == 0, "restart re-ran a pin the checkpoint recorded"
    assert bytes.fromhex(tid[2:]) in eng.solutions
    resumed = [e["stage"] for e in node2.obs.journal.events(
        kind="pipeline_stage", taskid=tid) if e.get("resumed")]
    assert resumed == ["pin"]
    assert node2.db.get_pipeline_stage(tid) is None
    node2.close()
    return {"state": list(state), "writes": chain_writes(eng)}


def sc_lost_window_converges(P, tmp_path):
    """kill -9: the whole deferred sqlite window is lost, so the next
    life redoes the pin and converges to the same CID, one commitment."""
    eng, mid, spawn = _crash_world(P, tmp_path)
    node, _, p1 = spawn()
    tid = submit(eng, mid)
    node.chain.signal_commitment = lambda c: (_ for _ in ()).throw(
        KeyboardInterrupt("sim kill"))
    with pytest.raises(KeyboardInterrupt):
        drain(node)
    assert p1.calls == 1
    assert node.db.get_pipeline_stage(tid) is None
    node.close()

    node2, _, p2 = spawn()
    drain(node2)
    assert p2.calls == 1, "a lost window must be re-derived, the pin too"
    sol = eng.solutions[bytes.fromhex(tid[2:])]
    assert "0x" + sol.cid.hex() == P.cid_hex(P.cid_of(p2.pinned[tid]))
    assert p2.pinned[tid] == p1.pinned[tid]
    node2.close()
    return {"writes": chain_writes(eng)}


def sc_config(P):
    cfg = P.config.load_config({"pipeline": {
        "enabled": True, "depth": 3, "encode_workers": 2,
        "max_inflight_pins": 8}})
    assert cfg.pipeline.enabled and cfg.pipeline.depth == 3
    assert not P.config.load_config({}).pipeline.enabled
    errors = []
    for bad in ({"depth": 0}, {"encode_workers": -1},
                {"max_inflight_pins": 0}):
        with pytest.raises(P.config.ConfigError,
                           match=next(iter(bad))) as e:
            P.config.load_config({"pipeline": bad})
        errors.append(str(e.value))
    return {"errors": errors}


SCENARIOS = {
    "on_vs_off_sd15_batch1": _on_vs_off(SD15Fake, 1),
    "on_vs_off_sd15_batch4": _on_vs_off(SD15Fake, 4),
    "on_vs_off_plain_batch1": _on_vs_off(PlainFake, 1),
    "on_vs_off_plain_batch4": _on_vs_off(PlainFake, 4),
    **{f.__name__[3:]: f for f in (
        sc_inline_encode, sc_depth_k_prefetch, sc_stage_events_monotonic,
        sc_metrics_moving, sc_tick_one_commit, sc_chunk_failure,
        sc_worker_death, sc_bounded_buffers, sc_config)},
}
CRASH_SCENARIOS = {f.__name__[3:]: f for f in (
    sc_resume_recorded_pin, sc_lost_window_converges)}


@functools.cache
def _reference(name: str):
    return SCENARIOS[name](_pkg("arbius_tpu"))


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pipeline_scenario_matches_reference(name, pkg):
    """The scenario's checks hold in `pkg`, and what it records equals a
    run of the reference's (for the reference itself: a second run)."""
    assert SCENARIOS[name](_pkg(pkg)) == _reference(name)


@pytest.mark.parametrize("name", list(CRASH_SCENARIOS))
def test_pipeline_crash_resume_matches_reference(name, tmp_path):
    got = {pkg: CRASH_SCENARIOS[name](_pkg(pkg), tmp_path)
           for pkg in PACKAGES}
    assert got["arbius_tpu_torch"] == got["arbius_tpu"]


# -- the tiny anythingv3 on the CPU -----------------------------------------

@pytest.fixture(scope="module")
def tiny_runner():
    P = _pkg("arbius_tpu_torch")
    mid = "0x" + "00" * 32
    cfg = P.node.MiningConfig(compile_cache_dir=None, models=(
        P.node.ModelConfig(id=mid, template="anythingv3", tiny=True),))
    return P.node.build_registry(cfg, device="cpu").get(mid).runner


def test_tiny_sd15_bytes_identical_pipeline_on_vs_off(tiny_runner):
    """The real runner (dispatch/finalize on CPU tensors) at canonical
    batch 2, three tasks at 128x128 and 2 steps: the same CIDs, pinned
    PNGs and chain writes with the pipeline on and off."""
    P = _pkg("arbius_tpu_torch")
    runs = []
    for pipeline in (None, pipe_on(P)):
        eng, node, mid, pinner = world(P, tiny_runner, pipeline=pipeline,
                                       canonical_batch=2)
        for i in range(3):
            eng.submit_task(USER, 0, USER, bytes.fromhex(mid[2:]), 0,
                            json.dumps({
                                "prompt": f"a lighthouse {i}",
                                "negative_prompt": "", "width": 128,
                                "height": 128, "num_inference_steps": 2,
                                "guidance_scale": 5.0 + i}).encode())
        drain(node)
        assert node.db.failed_jobs() == []
        runs.append((pinner.pinned, chain_writes(eng)))
        node.close()
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == 3


def test_node_run_trace_summary():
    """tools/node_run_trace.py's reading of one dispatch's Chrome trace:
    device busy time is the union of kernel and copy intervals, idle is
    the rest of the device span, and the lag is how far the last device
    end trails the last launch call."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    from node_run_trace import summarize

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        ev("cuda_runtime", "cudaLaunchKernel", 0, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 10),
        ev("cuda_runtime", "cudaStreamSynchronize", 30, 500),
        ev("cpu_op", "aten::conv2d", 0, 40),
        ev("kernel", "k1", 100, 1000),
        ev("kernel", "k2", 600, 1000),      # overlaps k1 by 500 us
        ev("gpu_memcpy", "Memcpy DtoH", 3600, 400),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0}]}
    got = summarize(trace)
    assert got == {"kernels": 2, "launches": 2, "busy_ms": 1.9,
                   "device_span_ms": 3.9, "idle_share": 1 - 1.9 / 3.9,
                   "enqueue_ms": 0.03, "host_us_per_launch": 15.0,
                   "lag_ms": 3.97}
    assert summarize({"traceEvents": []}) == {"kernels": 0, "launches": 0}


def test_native_png_from_many_threads_in_a_fresh_process():
    """The encode pool calls the native deflate from several threads at
    once. In a fresh process (the library's first calls), 16 threads
    released together under a short switch interval each encode PNGs,
    and every one equals the pure-Python encoder's bytes."""
    import subprocess
    import sys

    script = (
        "import sys, threading\n"
        "import numpy as np\n"
        "from arbius_tpu_torch.codecs import _native, png\n"
        "if _native.deflate_fixed() is None:\n"
        "    sys.exit(3)\n"
        "rng = np.random.default_rng(0)\n"
        "imgs = [rng.integers(0, 4, (48, 48, 3), dtype=np.uint8)\n"
        "        for _ in range(8)]\n"
        "go = threading.Barrier(16)\n"
        "out = [None] * 16\n"
        "def work(i):\n"
        "    go.wait()\n"
        "    out[i] = [png.encode_png(im) for im in imgs]\n"
        "sys.setswitchinterval(1e-6)\n"
        "ts = [threading.Thread(target=work, args=(i,)) for i in range(16)]\n"
        "for t in ts:\n"
        "    t.start()\n"
        "for t in ts:\n"
        "    t.join(timeout=60)\n"
        "sys.setswitchinterval(0.005)\n"
        "assert not any(t.is_alive() for t in ts)\n"
        "_native.deflate_fixed = lambda: None   # the pure-Python path\n"
        "want = [png.encode_png(im) for im in imgs]\n"
        "assert all(o == want for o in out)\n")
    res = subprocess.run([sys.executable, "-c", script],
                         cwd=pathlib.Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    if res.returncode == 3:
        pytest.skip("no g++ to build csrc/codecs.cc")
    assert res.returncode == 0, res.stdout + res.stderr
