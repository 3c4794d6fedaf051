"""The port's fleet (arbius_tpu_torch/fleet/: the sqlite lease table, the
coordinator, the worker's lease feed) and fleetscope
(arbius_tpu_torch/obs/fleetscope.py: sidecars, federation, the SLO
report), renamed copies of the reference's, on the CPU.

The reference's suites (tests/test_fleet.py, tests/test_fleetscope.py)
run on the port through tests/torch_ported.py: each module's text with
`arbius_tpu.` read as `arbius_tpu_torch.` is loaded as a module of its
own, and each of its tests is a case here. The cases that drive the
reference's command-line tools (tools/fleetscope.py, tools/obs_dump.py,
which the port does not have: ROADMAP queue 1 item 12) stay the
reference's own."""
from __future__ import annotations

import ast
import pathlib

import pytest

from torch_ported import cases, renamed_module, run_case

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = {p.stem for p in (REPO / "tools").glob("*.py")}


def _tool_cases(path: pathlib.Path) -> set[str]:
    """The tests of `path` that import a module of tools/."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and any(
                isinstance(n, ast.ImportFrom) and n.module in TOOLS
                for n in ast.walk(node)):
            out.add(node.name)
    return out


FLEET = renamed_module(REPO / "tests" / "test_fleet.py")
SCOPE_PATH = REPO / "tests" / "test_fleetscope.py"
SCOPE = renamed_module(SCOPE_PATH)
SCOPE_TOOL_CASES = _tool_cases(SCOPE_PATH)
table = FLEET.table             # the lease table fixture of test_fleet.py


def test_ported_suites_run_the_port():
    assert FLEET.LeaseTable.__module__ == "arbius_tpu_torch.fleet.lease"
    assert SCOPE.ObsSidecar.__module__ == "arbius_tpu_torch.obs.fleetscope"
    assert SCOPE_TOOL_CASES == {
        "test_fleetscope_cli_prom_and_slo", "test_fleetscope_cli_timeline",
        "test_corrupt_sidecar_is_a_usage_error_not_a_traceback",
        "test_obs_dump_fleet_mode"}
    assert len(cases(FLEET)) >= 25
    assert len(set(cases(SCOPE)) - SCOPE_TOOL_CASES) >= 20


@pytest.mark.parametrize("case", cases(FLEET))
def test_fleet_case_on_the_port(case, request):
    run_case(FLEET, case, request)


@pytest.mark.parametrize("case", [c for c in cases(SCOPE)
                                  if c not in SCOPE_TOOL_CASES])
def test_fleetscope_case_on_the_port(case, request):
    run_case(SCOPE, case, request)


def test_corrupt_sidecar_fails_readably_on_the_port(tmp_path):
    """The tools-free half of the reference's corrupt-sidecar case: the
    reader raises ValueError naming the file, and the federated metrics
    server answers a diagnosable 500."""
    import urllib.error
    import urllib.request

    from arbius_tpu_torch.obs.fleetscope import (
        FleetMetricsServer,
        read_sidecars,
    )

    (tmp_path / "worker-9.obs.sqlite").write_bytes(b"not a sqlite file")
    with pytest.raises(ValueError, match="unreadable obs sidecar"):
        read_sidecars(str(tmp_path))
    server = FleetMetricsServer(str(tmp_path))
    server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=10)
        assert ei.value.code == 500
        assert b"unreadable obs sidecar" in ei.value.read()
    finally:
        server.stop()
