"""The port's operator control RPC (arbius_tpu_torch/node/rpc.py) against
the reference's, on the CPU: both packages' `ControlRPC` serve a node
that mined one task through the same script (tests/test_torch_node.py's
world and fake runner), and every view answers the same JSON, text or
HTML over HTTP, apart from host timings. The port refuses perfscope
until ROADMAP queue 1 item 12 ports it, and these nodes run with the
alert engine off, so /debug/costmodel's perfscope join and /debug/alerts
answer what the reference answers with both off (the alert engine's
views: tests/test_torch_healthwatch.py). A view that raises
answers 500 and is counted, and the server goes on answering."""
from __future__ import annotations

import importlib
import json
import urllib.error
import urllib.request

import pytest

from test_torch_node import PACKAGES, _pkg, build_world, drain, submit

TIMINGS = ("solve_latency_p50", "solve_latency_p95", "stage_infer_p50_s",
           "stage_commit_p50_s")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _spans(nodes):
    """A span tree without its timings."""
    return [(n["name"], _spans(n.get("children", []))) for n in nodes]


def _serve(pkg: str, tmp_path, **cfg) -> dict:
    """Mine one task, submit one through the form, then read every view
    of `pkg`'s ControlRPC (its node's config `cfg` beside the world's)."""
    P = _pkg(pkg)
    w = build_world(P, store_dir=str(tmp_path / pkg / "store"), **cfg)
    rpc = importlib.import_module(f"{pkg}.node.rpc").ControlRPC(w.node,
                                                                port=0)
    rpc.start()
    try:
        tid = submit(w, prompt="a lighthouse")
        drain(w.node)
        code, sub = _post(rpc.port, "/api/tasks/submit", {
            "model": w.mid, "fee": 0,
            "input": {"prompt": "via the form", "negative_prompt": ""}})
        assert code == 200 and sub["submitted"]
        drain(w.node)
        out = {"submitted": sub}
        for path in ("/api/tasks", "/api/models", "/api/jobs/get",
                     "/api/chain/info"):
            code, body = _get(rpc.port, path)
            out[path] = (code, json.loads(body))
        code, body = _get(rpc.port, f"/debug/journal?taskid={tid}")
        out["/debug/journal"] = (code, [(e["kind"], e.get("name"))
                                        for e in json.loads(body)["events"]])
        code, body = _get(rpc.port, "/api/metrics")
        out["/api/metrics"] = (code, {k: v for k, v in json.loads(
            body).items() if k not in TIMINGS})
        code, body = _get(rpc.port, "/metrics")
        assert code == 200
        out["/metrics"] = sorted(
            ln for ln in body.splitlines()
            if ln.startswith(("arbius_solutions_submitted_total ",
                              "arbius_tasks_seen_total ")))
        out["mesh_devices"] = [ln for ln in body.splitlines()
                               if ln.startswith("arbius_mesh_devices ")]
        code, body = _get(rpc.port, f"/debug/trace?taskid={tid}")
        trace = json.loads(body)
        out["/debug/trace"] = (code, _spans(trace["spans"]))
        for path in (f"/task/{tid}", f"/history/{w.chain.address}",
                     "/models"):
            out[path] = _get(rpc.port, path)
        code, body = _get(rpc.port, "/debug/costmodel")
        cost = json.loads(body)
        out["/debug/costmodel"] = (code, sorted(cost), cost["sched"],
                                   cost["aot_disk_warm"], cost["layout"])
        out["perfscope"] = cost["perfscope"]
        out["/debug/alerts"] = _get(rpc.port, "/debug/alerts")
        out["/api/tx/raw"] = _post(rpc.port, "/api/tx/raw",
                                   {"raw": "0x02"})
        # a view that raises answers 500, is counted, and the server
        # goes on answering
        rpc.recent_tasks = lambda limit=50: 1 / 0
        out["broken"] = _get(rpc.port, "/api/tasks")
        errors = w.node.obs.registry.counter("arbius_rpc_errors_total")
        out["rpc_errors"] = errors.value()
        out["after"] = _get(rpc.port, "/models")[0]
    finally:
        rpc.stop()
        w.node.close()
    return out


def test_control_rpc_views_match_reference(tmp_path):
    got = {pkg: _serve(pkg, tmp_path) for pkg in PACKAGES}
    ours, ref = got["arbius_tpu_torch"], got["arbius_tpu"]
    assert ours["/metrics"] == ["arbius_solutions_submitted_total 2",
                                "arbius_tasks_seen_total 2"]
    # perfscope and alerts are off in both nodes
    assert ours["perfscope"] is None
    code, body = ours["/debug/alerts"]
    assert (code, json.loads(body)) == (200, {"enabled": False,
                                              "alerts": []})
    assert ours["broken"][0] == 500 and ours["rpc_errors"] == 1
    assert ours["after"] == 200
    assert ours == ref


def test_control_rpc_views_match_reference_on_dp2_mesh(tmp_path):
    """The same views from nodes booted with mesh {"dp": 2}: the
    reference's over two of its 8 virtual CPU devices, the port's over
    two virtual CPU lanes; the cost model's layout is "dp2" in both."""
    from arbius_tpu_torch.parallel import virtual_lanes

    ref = _serve("arbius_tpu", tmp_path / "ref", mesh={"dp": 2})
    with virtual_lanes(2, "cpu"):
        ours = _serve("arbius_tpu_torch", tmp_path / "port",
                      mesh={"dp": 2})
    assert ours["/debug/costmodel"][-1] == "dp2"
    assert ours["mesh_devices"] == ["arbius_mesh_devices 2"]
    assert ours == ref


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failing_view_answers_500(pkg, tmp_path):
    """The reference's obs_e2e case: a view bug answers 500 JSON naming
    the error, without killing the request thread."""
    P = _pkg(pkg)
    w = build_world(P)
    rpc = importlib.import_module(f"{pkg}.node.rpc").ControlRPC(w.node,
                                                                port=0)
    rpc.start()
    try:
        rpc.metrics = lambda: {}["boom"]
        code, body = _get(rpc.port, "/api/metrics")
        assert code == 500 and "KeyError" in json.loads(body)["error"]
        assert _get(rpc.port, "/api/models")[0] == 200
    finally:
        rpc.stop()
        w.node.close()
