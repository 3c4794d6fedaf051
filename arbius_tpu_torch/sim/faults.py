"""The fault plane: seeded adversarial wrappers around the node's I/O.

Three edges, one shared `FaultPlane` (rng streams + virtual clock +
audit trace):

  `FaultTransport`   wraps `DevnetNode.request` — the node's ENTIRE
                     chain surface (views, event polling, signed txs)
                     crosses this one choke point, so transport errors,
                     lost tx responses, injected latency, delayed/
                     replayed logs, shallow log-replay reorgs, and the
                     crash trigger all live here. Every *landed* write
                     is RLP/ABI-decoded into the audit trace the
                     invariant checkers consume.
  `SimPinner`        a pinning "service" that fails, stalls, or answers
                     a mismatched root CID (raising `PinMismatchError`
                     exactly as the remote pinners do).
  `FaultyRunner`     a deterministic solve function (bytes are a pure
                     hash of input+seed — fault draws NEVER touch
                     output bytes, only timing/failure) that can run
                     slow or crash mid-batch.

`SimCrash` derives from BaseException on purpose: the node's job loop
quarantines `Exception`s, and a simulated `kill -9` must tear through
those handlers exactly as a real process death would — the harness
catches it at the tick boundary and reboots the node from its sqlite
checkpoint.

Reorg model: the engine state machine never forks; a "reorg" here is
what a log subscriber observes during a shallow one — recent logs
re-served, out of order, past the consumer's high-water mark. The
node's INSERT OR IGNORE event handling must absorb it.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

from dataclasses import dataclass, field

from arbius_tpu_torch.chain.devnet import EVENT_TOPIC0, DevnetError
from arbius_tpu_torch.chain.rlp import decode_signed_eip1559
from arbius_tpu_torch.chain.rpc_client import ENGINE_FNS, RpcError, selector
from arbius_tpu_torch.l0.abi import abi_decode
from arbius_tpu_torch.node.pinners import PinMismatchError
from arbius_tpu_torch.node.rpc_chain import RpcChain
from arbius_tpu_torch.obs import current_obs

_TASK_SUBMITTED_TOPIC = "0x" + EVENT_TOPIC0["TaskSubmitted"].hex()

# selector -> (method name, arg types) for every write the audit decodes
_WRITE_ABI = {selector(sig): (name, types)
              for name, (sig, types) in ENGINE_FNS.items()}
_WRITE_ABI[selector("approve(address,uint256)")] = (
    "approve", ["address", "uint256"])


class SimCrash(BaseException):
    """Simulated process death (kill -9). BaseException so the node's
    quarantine handlers cannot swallow it — only the harness catches."""


class SimPinError(RuntimeError):
    """Transient pinning-service failure (the 5xx class)."""


class SimRunnerError(RuntimeError):
    """Runner died mid-batch (the OOM/preemption class)."""


@dataclass
class AuditRecord:
    """One landed (or rejected) chain write, as decoded from the raw tx."""
    seq: int
    block: int          # block the tx lands in (pre-automine number)
    now: int            # chain time at apply
    method: str
    sender: str
    values: list
    ok: bool
    error: str = ""


@dataclass
class PendingLog:
    release_poll: int
    log: dict = field(default_factory=dict)


class FaultPlane:
    """Shared state of one scenario run: rng streams, clock, fault
    counters, the audit trace, and the commitment registry."""

    def __init__(self, scenario, seed: int, clock, engine,
                 miner_address: str):
        from arbius_tpu_torch.sim.rng import SimRng

        self.scenario = scenario
        self.spec = scenario.faults
        self.seed = seed
        self.clock = clock
        self.engine = engine
        self.miner_address = miner_address.lower()
        root = SimRng(seed)
        self._rng_rpc = root.stream("rpc")
        self._rng_events = root.stream("events")
        self._rng_pin = root.stream("pin")
        self._rng_runner = root.stream("runner")
        self._rng_decode = root.stream("decode")
        self.armed = False           # faults suppressed until the harness arms
        self.fault_counts: dict[str, int] = {}
        self.audit: list[AuditRecord] = []
        self.commitments: dict[bytes, tuple[str, str, str]] = {}
        self.delivered_taskids: set[str] = set()
        self.crash_seqs: list[int] = []
        self._commits_landed = 0
        self._crash_pending = False
        self.poll_index = 0
        self._delayed: list[PendingLog] = []
        self._replay_next: list[dict] = []

    # -- bookkeeping ------------------------------------------------------
    def count(self, kind: str) -> None:
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        obs = current_obs()
        if obs is not None:
            obs.registry.counter(
                "arbius_sim_faults_total",
                "Faults injected by the simnet fault plane, by kind",
                labelnames=("kind",)).inc(kind=kind)

    def register_commitment(self, commitment: bytes, sender: str,
                            taskid: str, cid: str) -> None:
        """Plaintext (validator, taskid, cid) behind a commitment hash —
        recorded at generate time, where the args are still visible."""
        self.commitments[commitment] = (sender.lower(), taskid, cid)

    def record(self, method: str, sender: str, values: list, *, ok: bool,
               error: str = "") -> AuditRecord:
        rec = AuditRecord(seq=len(self.audit),
                          block=self.engine.block_number,
                          now=self.engine.now, method=method,
                          sender=sender, values=values, ok=ok, error=error)
        self.audit.append(rec)
        return rec

    def pending_events(self) -> int:
        return len(self._delayed) + len(self._replay_next)

    # -- crash trigger ----------------------------------------------------
    def _note_landed(self, method: str, sender: str) -> bool:
        """Count the miner's landed commits; True = die now (once)."""
        if (self.spec.crash_after_commit is None
                or method != "signalCommitment"
                or sender != self.miner_address):
            return False
        self._commits_landed += 1
        if (not self._crash_pending
                and self._commits_landed == self.spec.crash_after_commit):
            self._crash_pending = True
            return True
        return False

    def crash_now(self) -> SimCrash:
        self.count("crash")
        self.crash_seqs.append(len(self.audit))
        obs = current_obs()
        if obs is not None:
            obs.event("sim_crash", commits_landed=self._commits_landed)
        return SimCrash(
            f"sim: node killed after commit #{self._commits_landed} landed")

    # -- edge gates (called by the wrappers) ------------------------------
    def rpc_gate(self, method: str) -> None:
        """Latency + 5xx for read-side RPC (views, polls)."""
        if not self.armed:
            return
        if self.spec.latency_max > 0:
            lat = self._rng_rpc.randint(0, self.spec.latency_max)
            if lat:
                # counted like every injected fault: timing-only faults
                # still mark a run as fault-laden, which is what lets
                # SIM113 hold "clean scenarios raise no alerts" while
                # allowing latency-driven pipeline stalls to alert
                # (docs/healthwatch.md coverage map)
                self.count("latency")
                self.clock.advance(lat)
        if method == "eth_getLogs":
            if self._rng_rpc.chance(self.spec.poll_error_rate):
                self.count("poll_error")
                raise RpcError("sim: eth_getLogs 503")
        elif method == "eth_call":
            if self._rng_rpc.chance(self.spec.view_error_rate):
                self.count("view_error")
                raise RpcError("sim: eth_call 503")

    def pin_gate(self) -> None:
        if not self.armed:
            return
        if self.spec.pin_stall_seconds > 0:
            stall = self._rng_pin.randint(0, self.spec.pin_stall_seconds)
            if stall:
                self.count("pin_stall")
                self.clock.advance(stall)
        if self._rng_pin.chance(self.spec.pin_fail_rate):
            self.count("pin_fail")
            raise SimPinError("sim: pinning service 502")
        if self._rng_pin.chance(self.spec.pin_mismatch_rate):
            self.count("pin_mismatch")
            raise PinMismatchError(
                "sim: service answered a different root CID")

    def runner_gate(self) -> None:
        if not self.armed:
            return
        if self.spec.runner_slow_seconds > 0:
            slow = self._rng_runner.randint(0, self.spec.runner_slow_seconds)
            if slow:
                self.count("runner_slow")   # timing-only, see rpc_gate
                self.clock.advance(slow)
        if self._rng_runner.chance(self.spec.runner_crash_rate):
            self.count("runner_crash")
            raise SimRunnerError("sim: runner crashed mid-batch")

    def decode_gate(self) -> None:
        """Text-family decode stall (docs/text-serving.md): the solve
        "decoded zero output bytes" — surfaced through the SAME
        production counter the real TextGenRunner.finalize bumps, so
        the healthwatch decode_stall rule sees sim and production
        stalls identically. Observation-only: output bytes are NEVER
        touched (the sim's determinism anchor holds)."""
        if not self.armed:
            return
        if self._rng_decode.chance(self.spec.decode_stall_rate):
            from arbius_tpu_torch.node.solver import count_decode_stall

            self.count("decode_stall")
            count_decode_stall()


class FaultTransport:
    """JsonRpcTransport-compatible wrapper over an in-process DevnetNode
    with the fault plane's chain-RPC edge applied. This is the ONLY path
    between the node under test and the chain."""

    def __init__(self, dev, plane: FaultPlane):
        self.dev = dev
        self.plane = plane

    def request(self, method: str, params: list):
        self.plane.rpc_gate(method)
        if method == "eth_sendRawTransaction":
            return self._send_raw(params)
        if method == "eth_getLogs":
            return self._get_logs(params)
        try:
            return self.dev.request(method, params)
        except DevnetError as e:
            raise RpcError(str(e)) from None

    # -- writes -----------------------------------------------------------
    def _decode_write(self, raw_hex: str) -> tuple[str, str, list]:
        dec = decode_signed_eip1559(bytes.fromhex(raw_hex[2:]))
        sel = dec.tx.data[:4]
        name, types = _WRITE_ABI.get(sel, (sel.hex(), None))
        values = abi_decode(types, dec.tx.data[4:]) if types else []
        return name, dec.sender.lower(), values

    def _send_raw(self, params: list):
        plane = self.plane
        method, sender, values = self._decode_write(params[0])
        if plane.armed and plane._rng_rpc.chance(plane.spec.tx_error_rate):
            plane.count("tx_error")
            plane.record(method, sender, values, ok=False,
                         error="sim: dropped before send")
            raise RpcError(f"sim: {method} tx dropped before send")
        try:
            result = self.dev.request("eth_sendRawTransaction", params)
        except DevnetError as e:
            plane.record(method, sender, values, ok=False, error=str(e))
            raise RpcError(str(e)) from None
        plane.record(method, sender, values, ok=True)
        if plane._note_landed(method, sender):
            raise plane.crash_now()
        if plane.armed and plane._rng_rpc.chance(
                plane.spec.tx_lost_response_rate):
            plane.count("tx_lost_response")
            raise RpcError(f"sim: {method} landed but the response was lost")
        return result

    # -- event plane ------------------------------------------------------
    def _note_delivered(self, logs: list[dict]) -> None:
        for lg in logs:
            if lg.get("topics") and lg["topics"][0] == _TASK_SUBMITTED_TOPIC:
                self.plane.delivered_taskids.add(lg["topics"][1])

    def _get_logs(self, params: list):
        plane = self.plane
        try:
            logs = self.dev.request("eth_getLogs", params)
        except DevnetError as e:  # pragma: no cover — devnet never 5xxs
            raise RpcError(str(e)) from None
        plane.poll_index += 1
        out: list[dict] = []
        # release previously-delayed logs first (they are the oldest)
        still: list[PendingLog] = []
        for p in plane._delayed:
            if p.release_poll <= plane.poll_index:
                out.append(p.log)
            else:
                still.append(p)
        plane._delayed = still
        for lg in logs:
            if plane.armed and plane._rng_events.chance(
                    plane.spec.event_delay_rate):
                plane.count("event_delay")
                plane._delayed.append(PendingLog(
                    plane.poll_index + plane._rng_events.randint(1, 3), lg))
                continue
            out.append(lg)
            if plane.armed and plane._rng_events.chance(
                    plane.spec.event_replay_rate):
                plane.count("event_replay")
                plane._replay_next.append(lg)
        if plane._replay_next:
            # duplicates marked last poll ride along with this one
            out.extend(plane._replay_next)
            plane._replay_next = []
        if (plane.armed and plane.spec.reorg_every > 0
                and plane.poll_index % plane.spec.reorg_every == 0):
            cutoff = max(0, self.dev.engine.block_number
                         - plane.spec.reorg_depth)
            replayed = [lg for lg in self.dev.logs
                        if int(lg["blockNumber"], 16) >= cutoff]
            if replayed:
                plane.count("reorg")
                out.extend(replayed)
        self._note_delivered(out)
        return out


class AuditedRpcChain(RpcChain):
    """RpcChain that reports commitment plaintexts to the fault plane —
    the piece that lets the checkers resolve on-chain commitment hashes
    back to (validator, taskid, cid) without inverting keccak."""

    def __init__(self, client, token_address: str, plane: FaultPlane,
                 **kwargs):
        super().__init__(client, token_address, **kwargs)
        self._plane = plane

    def generate_commitment(self, taskid: str, cid: str) -> bytes:
        c = super().generate_commitment(taskid, cid)
        self._plane.register_commitment(c, self.address, taskid, cid)
        return c


class SimPinner:
    """Pinner-protocol "remote service" under fault-plane control: the
    root CID is computed locally (the real remote pinners verify against
    exactly this), and the plane decides whether the service call fails,
    stalls, or answers a mismatched root."""

    def __init__(self, plane: FaultPlane):
        self.plane = plane
        self.pinned: dict[str, int] = {}    # cid hex -> times pinned

    def pin_files(self, files: dict[str, bytes], taskid: str = "") -> bytes:
        from arbius_tpu_torch.l0.cid import cid_of_solution_files

        self.plane.pin_gate()
        root = cid_of_solution_files(files)
        key = "0x" + root.hex()
        self.pinned[key] = self.pinned.get(key, 0) + 1
        return root

    def pin_blob(self, content: bytes, filename: str = "input") -> bytes:
        from arbius_tpu_torch.l0.cid import dag_of_file

        self.plane.pin_gate()
        cid = dag_of_file(content).cid
        key = "0x" + cid.hex()
        self.pinned[key] = self.pinned.get(key, 0) + 1
        return cid


class FaultyRunner:
    """Deterministic solve function with timing/crash faults. Output
    bytes are a pure hash of (hydrated-minus-seed, seed) — a fault can
    delay or kill a solve but can NEVER change the bytes, so the CID a
    task commits to is identical across retries, crashes, and seeds of
    the fault schedule (the sim's determinism anchor)."""

    def __init__(self, plane: FaultPlane, out_name: str = "out-1.png"):
        self.plane = plane
        self.out_name = out_name

    def __call__(self, hydrated: dict, seed: int) -> dict:
        import hashlib
        import json

        self.plane.runner_gate()
        canon = json.dumps(
            {k: v for k, v in hydrated.items() if k != "seed"},
            sort_keys=True).encode()
        blob = hashlib.sha256(canon + seed.to_bytes(8, "big")).digest()
        return {self.out_name: b"\x89PNG" + blob}


class FaultyTextRunner(FaultyRunner):
    """Text-family hash-fake (docs/text-serving.md): output bytes are a
    pure hash stream of (hydrated-minus-seed, seed) truncated to the
    task's decode budget — so solve cost and output size track
    `max_new_tokens` the way a real decode loop's do, while staying
    jax-free. Mirrors the production TextGenRunner's intake hook
    (`prepare_hydrated` stamps the sequence buckets) so costsched packs
    real 9-tuple sequence buckets in simnet. Decode-stall faults are
    counted and surfaced through the production stall counter but NEVER
    touch the bytes (the sim's determinism anchor)."""

    # the production defaults (node/config.py TextgenConfig) — simnet
    # buckets must look like a shipped node's
    PROMPT_EDGES = (32, 64)
    DECODE_EDGES = (16, 32)

    def __init__(self, plane: FaultPlane, out_name: str = "out-1.txt"):
        super().__init__(plane, out_name)

    def prepare_hydrated(self, hydrated: dict) -> dict:
        h = dict(hydrated)
        need = len(str(h.get("prompt", "")).encode("utf-8")) + 2
        h["_prompt_bucket"] = next(
            (e for e in self.PROMPT_EDGES if e >= need),
            self.PROMPT_EDGES[-1])
        budget = int(h.get("max_new_tokens") or 16)
        h["_decode_bucket"] = next(
            (e for e in self.DECODE_EDGES if e >= max(1, budget)),
            self.DECODE_EDGES[-1])
        return h

    def __call__(self, hydrated: dict, seed: int) -> dict:
        import hashlib
        import json

        self.plane.decode_gate()
        self.plane.runner_gate()
        canon = json.dumps(
            {k: v for k, v in hydrated.items() if k != "seed"},
            sort_keys=True).encode()
        budget = int(hydrated.get("max_new_tokens") or 16)
        stream = b""
        counter = 0
        while len(stream) < budget:
            stream += hashlib.sha256(
                canon + seed.to_bytes(8, "big")
                + counter.to_bytes(4, "big")).digest()
            counter += 1
        return {self.out_name: stream[:budget]}
