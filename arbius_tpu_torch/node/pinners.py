"""Pinning strategies — local store, remote daemon, or Pinata; one interface.

The reference switches on `c.ipfs.strategy` between an ipfs-http-client
daemon and Pinata's HTTP API (`miner/src/ipfs.ts:28-76`, `:79-114`).
Same split here: `LocalPinner` persists into the node's own ContentStore
(the default — the node serves its own gateway), `HttpDaemonPinner`
POSTs to a kubo-style `/api/v0/add` endpoint, `PinataPinner` POSTs to
`pinning/pinFileToIPFS`. All return the root CID, and both remote pinners
VERIFY the service's answer against the locally computed CID — a service
that hashes differently would otherwise make the node commit a CID whose
bytes it can't prove. `MiningConfig.ipfs.strategy` selects the strategy
(`build_pinner`), mirroring the reference's `types.ts:3-54` config shape.
"""
from __future__ import annotations

import json
import urllib.request
from typing import Protocol

from arbius_tpu_torch.l0.base58 import b58encode
from arbius_tpu_torch.l0.cid import cid_of_solution_files
from arbius_tpu_torch.node.store import ContentStore
from arbius_tpu_torch.obs import span


class Pinner(Protocol):
    def pin_files(self, files: dict[str, bytes], taskid: str = "") -> bytes:
        """Persist a solution's files; return the dir-wrapped root CID.
        `taskid` names the wrapping directory on services that display one
        (Pinata); it never affects the root CID."""
        ...

    def pin_blob(self, content: bytes, filename: str = "input") -> bytes:
        """Persist one un-wrapped file (task inputs — the reference's
        pinFileToIPFS, `miner/src/ipfs.ts:79-114`); return its CID."""
        ...


class LocalPinner:
    def __init__(self, store: ContentStore):
        self.store = store

    def pin_files(self, files: dict[str, bytes], taskid: str = "") -> bytes:
        with span("pin.files", strategy="local", n=len(files),
                  taskid=taskid or None):
            return self.store.put_files(files)

    def pin_blob(self, content: bytes, filename: str = "input") -> bytes:
        with span("pin.blob", strategy="local", size=len(content)):
            return self.store.put_blob(content)


class PinMismatchError(RuntimeError):
    """Remote daemon returned a different root CID than computed locally."""


def multipart_request(url: str, chunks: list[bytes], boundary: str,
                      headers: dict | None = None) -> urllib.request.Request:
    """POST whose body is a LIST of chunks: each solution file rides as
    its own chunk, referenced rather than copied into one contiguous
    buffer — peak memory stays ~1× the output bytes instead of the 2×
    the old `b"".join` cost on multi-MB video outputs. urllib sends any
    iterable body chunk-by-chunk but requires an explicit
    Content-Length for it, so we compute one here."""
    h = {"Content-Type": f"multipart/form-data; boundary={boundary}",
         "Content-Length": str(sum(len(c) for c in chunks))}
    if headers:
        h.update(headers)
    return urllib.request.Request(url, data=chunks, headers=h,
                                  method="POST")


class HttpDaemonPinner:
    """kubo `/api/v0/add` with the reference's exact options
    (`miner/src/ipfs.ts:11-16`): cid-version=0, sha2-256, 262144 chunker,
    rawLeaves=false, wrap-with-directory. `opener` is injectable for
    tests (zero-egress environment)."""

    BOUNDARY = "arbius-tpu-multipart"

    def __init__(self, api_url: str, timeout: float = 60.0, opener=None):
        self.api_url = api_url.rstrip("/")
        self.timeout = timeout
        self.opener = opener or urllib.request.urlopen

    def _multipart(self, files: dict[str, bytes]) -> list[bytes]:
        parts = []
        for name in sorted(files):
            parts.append(
                (f"--{self.BOUNDARY}\r\n"
                 f'Content-Disposition: form-data; name="file"; '
                 f'filename="{name}"\r\n'
                 "Content-Type: application/octet-stream\r\n\r\n"
                 ).encode())
            parts.append(files[name])   # referenced, never copied
            parts.append(b"\r\n")
        parts.append(f"--{self.BOUNDARY}--\r\n".encode())
        return parts

    def pin_files(self, files: dict[str, bytes], taskid: str = "") -> bytes:
        local_root = cid_of_solution_files(files)
        query = ("cid-version=0&hash=sha2-256&chunker=size-262144"
                 "&raw-leaves=false&wrap-with-directory=true&pin=true")
        req = multipart_request(f"{self.api_url}/api/v0/add?{query}",
                                self._multipart(files), self.BOUNDARY)
        with span("pin.files", strategy="http_daemon", n=len(files),
                  taskid=taskid or None), \
                self.opener(req, timeout=self.timeout) as r:
            lines = [json.loads(l) for l in r.read().splitlines() if l]
        # the dir-wrap root is the entry with empty Name (ipfs.ts:42-47)
        roots = [e["Hash"] for e in lines if e.get("Name", "") == ""]
        if not roots or roots[-1] != b58encode(local_root):
            raise PinMismatchError(
                f"daemon root {roots[-1] if roots else None} != local "
                f"{b58encode(local_root)}")
        return local_root

    def pin_blob(self, content: bytes, filename: str = "input") -> bytes:
        from arbius_tpu_torch.l0.cid import dag_of_file

        local = dag_of_file(content).cid
        query = ("cid-version=0&hash=sha2-256&chunker=size-262144"
                 "&raw-leaves=false&pin=true")
        req = multipart_request(f"{self.api_url}/api/v0/add?{query}",
                                self._multipart({filename: content}),
                                self.BOUNDARY)
        with span("pin.blob", strategy="http_daemon", size=len(content)), \
                self.opener(req, timeout=self.timeout) as r:
            lines = [json.loads(l) for l in r.read().splitlines() if l]
        got = lines[-1]["Hash"] if lines else None
        if got != b58encode(local):
            raise PinMismatchError(
                f"daemon blob {got} != local {b58encode(local)}")
        return local


class PinataPinner:
    """Pinata `pinning/pinFileToIPFS` (`miner/src/ipfs.ts:79-114`): one
    multipart POST with every file at filepath `{taskid}/{name}` (Pinata
    wraps same-prefix files in a directory), pinataOptions cidVersion 0,
    Bearer-JWT auth. The returned IpfsHash is verified against the
    locally computed dir-wrap CID. `opener` is injectable for tests
    (zero-egress environment)."""

    BOUNDARY = "arbius-tpu-multipart"
    API_URL = "https://api.pinata.cloud/pinning/pinFileToIPFS"

    def __init__(self, jwt: str, timeout: float = 60.0, opener=None,
                 api_url: str | None = None):
        self.jwt = jwt
        self.timeout = timeout
        self.opener = opener or urllib.request.urlopen
        self.api_url = api_url or self.API_URL

    def _multipart(self, files: dict[str, bytes], taskid: str) -> list[bytes]:
        parts = []
        for name in sorted(files):
            parts.append(
                (f"--{self.BOUNDARY}\r\n"
                 f'Content-Disposition: form-data; name="file"; '
                 f'filename="{taskid}/{name}"\r\n'
                 "Content-Type: application/octet-stream\r\n\r\n"
                 ).encode())
            parts.append(files[name])   # referenced, never copied
            parts.append(b"\r\n")
        parts.append(
            (f"--{self.BOUNDARY}\r\n"
             'Content-Disposition: form-data; name="pinataOptions"\r\n\r\n'
             + json.dumps({"cidVersion": 0}) + "\r\n").encode())
        parts.append(f"--{self.BOUNDARY}--\r\n".encode())
        return parts

    def pin_files(self, files: dict[str, bytes], taskid: str = "task") -> bytes:
        local_root = cid_of_solution_files(files)
        req = multipart_request(
            self.api_url, self._multipart(files, taskid or "task"),
            self.BOUNDARY,
            headers={"Authorization": f"Bearer {self.jwt}"})
        with span("pin.files", strategy="pinata", n=len(files),
                  taskid=taskid or None), \
                self.opener(req, timeout=self.timeout) as r:
            got = json.loads(r.read()).get("IpfsHash")
        if got != b58encode(local_root):
            raise PinMismatchError(
                f"pinata root {got} != local {b58encode(local_root)}")
        return local_root

    def pin_blob(self, content: bytes, filename: str = "input") -> bytes:
        from arbius_tpu_torch.l0.cid import dag_of_file

        local = dag_of_file(content).cid
        parts = [
            (f"--{self.BOUNDARY}\r\n"
             f'Content-Disposition: form-data; name="file"; '
             f'filename="{filename}"\r\n'
             "Content-Type: application/octet-stream\r\n\r\n"
             ).encode(),
            content,                    # referenced, never copied
            b"\r\n",
            (f"--{self.BOUNDARY}\r\n"
             'Content-Disposition: form-data; name="pinataOptions"\r\n\r\n'
             + json.dumps({"cidVersion": 0}) + "\r\n").encode(),
            f"--{self.BOUNDARY}--\r\n".encode(),
        ]
        req = multipart_request(
            self.api_url, parts, self.BOUNDARY,
            headers={"Authorization": f"Bearer {self.jwt}"})
        with span("pin.blob", strategy="pinata", size=len(content)), \
                self.opener(req, timeout=self.timeout) as r:
            got = json.loads(r.read()).get("IpfsHash")
        if got != b58encode(local):
            raise PinMismatchError(
                f"pinata blob {got} != local {b58encode(local)}")
        return local


def build_pinner(ipfs_cfg, store: ContentStore | None):
    """MiningConfig.ipfs → live Pinner (None when nothing to pin with)."""
    if ipfs_cfg.strategy == "local":
        return LocalPinner(store) if store is not None else None
    if ipfs_cfg.strategy == "http_daemon":
        return HttpDaemonPinner(ipfs_cfg.daemon_url, timeout=ipfs_cfg.timeout)
    if ipfs_cfg.strategy == "pinata":
        return PinataPinner(ipfs_cfg.pinata_jwt, timeout=ipfs_cfg.timeout)
    raise ValueError(f"unknown ipfs strategy {ipfs_cfg.strategy!r}")
