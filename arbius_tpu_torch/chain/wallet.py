"""Ethereum wallet primitives — keygen, address derivation, signing.

Equivalent of the reference's `gen-wallet` hardhat task
(`contract/tasks/index.ts:12-21`) and the miner's ethers Wallet
(`miner/src/blockchain.ts:22-36`), self-contained: secp256k1 point
arithmetic in pure Python ints (the curve math is tiny and exact), keccak
from L0. No external crypto dependency to version-drift.

Signing is RFC-6979 deterministic ECDSA (the same scheme ethers uses), so
a given (key, message) always produces the same signature — consistent
with the framework's everything-deterministic stance.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets
from dataclasses import dataclass

from arbius_tpu_torch.l0.keccak import keccak256

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _point_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


# Scalar multiplication runs in Jacobian coordinates (x = X/Z², y =
# Y/Z³): the affine ladder above pays one modular inversion PER BIT
# (~256 `pow(a, -1, P)` per multiply — it dominated the simnet profile,
# where every chain write is a signed tx), Jacobian pays ONE at the end.
# `_point_add` stays as the affine reference; tests pin both paths equal.

def _jac_double(X1: int, Y1: int, Z1: int):
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return X3, Y3, Z3


def _jac_add(p1, p2):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == 0:
        return p2
    if Z2 == 0:
        return p1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return (0, 1, 0)        # P + (−P) = infinity
        return _jac_double(X1, Y1, Z1)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return X3, Y3, Z3


def _point_mul(k: int, point=(GX, GY)):
    if point is None:
        return None
    acc = (0, 1, 0)                 # infinity
    add = (point[0], point[1], 1)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(*add)
        k >>= 1
    if acc[2] == 0:
        return None
    zi = _inv(acc[2], P)
    zi2 = zi * zi % P
    return acc[0] * zi2 % P, acc[1] * zi2 % P * zi % P


@dataclass(frozen=True)
class Wallet:
    private_key: bytes

    @classmethod
    def generate(cls) -> "Wallet":
        while True:
            # detlint: allow[DET102] keygen WANTS OS entropy; wallets are
            # never created on the solve path
            key = secrets.token_bytes(32)
            if 0 < int.from_bytes(key, "big") < N:
                return cls(key)

    @classmethod
    def from_hex(cls, hexkey: str) -> "Wallet":
        key = bytes.fromhex(hexkey[2:] if hexkey.startswith("0x") else hexkey)
        if len(key) != 32 or not 0 < int.from_bytes(key, "big") < N:
            raise ValueError("private key must be 32 bytes in (0, n)")
        return cls(key)

    @property
    def public_key(self) -> bytes:
        x, y = _point_mul(int.from_bytes(self.private_key, "big"))
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")

    @property
    def address(self) -> str:
        """keccak(uncompressed pubkey)[12:] — standard Ethereum address."""
        return "0x" + keccak256(self.public_key)[12:].hex()

    def sign(self, message_hash: bytes) -> tuple[int, int, int]:
        """RFC-6979 deterministic ECDSA; returns (r, s, recovery_id) with
        low-s normalization (EIP-2)."""
        if len(message_hash) != 32:
            raise ValueError("sign expects a 32-byte hash")
        d = int.from_bytes(self.private_key, "big")
        z = int.from_bytes(message_hash, "big")

        # RFC 6979 §3.2 nonce derivation (HMAC-SHA256)
        V = b"\x01" * 32
        K = b"\x00" * 32
        x = self.private_key
        h1 = message_hash
        K = hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()
        K = hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()
        while True:
            V = hmac.new(K, V, hashlib.sha256).digest()
            k = int.from_bytes(V, "big")
            if 0 < k < N:
                point = _point_mul(k)
                r = point[0] % N
                if r != 0:
                    s = _inv(k, N) * (z + r * d) % N
                    if s != 0:
                        rec = point[1] & 1
                        if s > N // 2:   # EIP-2 low-s
                            s = N - s
                            rec ^= 1
                        return r, s, rec
            K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
            V = hmac.new(K, V, hashlib.sha256).digest()

    def sign_message(self, message: bytes) -> tuple[int, int, int]:
        """EIP-191 personal_sign: keccak('\\x19Ethereum Signed Message:\\n'
        + len + message)."""
        prefixed = b"\x19Ethereum Signed Message:\n" + \
            str(len(message)).encode() + message
        return self.sign(keccak256(prefixed))


def recover_address(message_hash: bytes, r: int, s: int, rec: int) -> str:
    """Recover the signer address (verification without a pubkey store)."""
    x = r
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y & 1 != rec:
        y = P - y
    z = int.from_bytes(message_hash, "big")
    r_inv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    sR = _point_mul(s, (x, y))
    zG = _point_mul(z)
    neg_zG = (zG[0], P - zG[1])
    q = _point_add(sR, neg_zG)
    q = _point_mul(r_inv % N, q)
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return "0x" + keccak256(pub)[12:].hex()
