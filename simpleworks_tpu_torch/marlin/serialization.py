"""Byte serialization for Marlin proofs and verifying keys.

Port of ``simpleworks_tpu/marlin/serialization.py`` (reference
``src/marlin/serialization.rs``: thin wrappers over arkworks
``CanonicalSerialize`` on the ark-marlin containers), byte for byte.  The
proving key's bytes are the reference's too: its index polynomials leave
Montgomery form on the device and come to the host in one copy, and the
SRS powers are read back from the planes as points (compressed one by one;
decompressing them costs ~2.5 ms a point in Python, so the serde suits small
keys: the disk checkpoint is the full-scale route).

The container layout here follows ark-marlin 0.3's ``Proof`` /
``IndexVerifierKey`` CanonicalSerialize shape — ordered struct fields,
``Vec<T>`` as u64 LE length + elements, ``Option<T>`` as a 1-byte tag —
over primitives that are already arkworks byte-layout (compressed points,
32-byte LE field elements):

* Proof: commitments ``Vec<Vec<Commitment>>`` (3 rounds: [w,z_a,z_b,mask],
  [t,g_1,h_1], [g_2,h_2]) | evaluations ``Vec<Fr>`` | prover_messages
  ``Vec<ProverMsg>`` (3 × EmptyMessage = variant byte 0) | pc_proof
  ``BatchLCProof``: ``Vec<kzg10::Proof>`` ([β, γ]; each w + Option
  random_v) + ``Option<Vec<Fr>>`` evals (None).
* Commitment (marlin_pc): 48B compressed comm | Option shifted_comm.
* VerifyingKey: index info (u64s) | index commitments ``Vec`` | g | γG
  option | h | beta_h | degree_bounds_and_shift_powers option-vec |
  srs max_degree.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..curves.bls12_377 import G1Point, G2Point
from ..device import resolve
from ..errors import ensure
from ..fields.bls12_377 import Fr
from ..fields.frvec import FrVec
from ..kzg.kzg10 import Commitment, UniversalSRS
from ..ops import g1_limb
from ..poly.dense import DensePoly
from . import (
    EVALUATION_ORDER,
    INDEX_POLYS,
    IndexProverKey,
    IndexVerifierKey,
    MarlinProof,
)
from .ahp import IndexInfo, index_from_polys, next_pow2

#: ark-marlin's per-round commitment grouping (Proof.commitments)
ROUND_GROUPS = [["w", "z_a", "z_b", "mask"], ["t", "g_1", "h_1"], ["g_2", "h_2"]]
ROUND_COMMS = [n for group in ROUND_GROUPS for n in group]
#: Proof.evaluations order: ark's label-sorted ordering (see
#: marlin.EVALUATION_ORDER)
ALL_EVALS = EVALUATION_ORDER


def _read_commitment(data: bytes, off: int) -> tuple[Commitment, int]:
    comm = G1Point.deserialize_compressed(data[off : off + 48])
    off += 48
    has_shifted = data[off]
    off += 1
    shifted = None
    if has_shifted:
        shifted = G1Point.deserialize_compressed(data[off : off + 48])
        off += 48
    return Commitment(comm=comm, shifted_comm=shifted), off


def serialize_proof(proof: MarlinProof) -> bytes:
    out = bytearray()
    out += struct.pack("<Q", len(ROUND_GROUPS))
    for group in ROUND_GROUPS:
        out += struct.pack("<Q", len(group))
        for name in group:
            out += proof.commitments[name].serialize()
    out += struct.pack("<Q", len(ALL_EVALS))
    for name in ALL_EVALS:
        out += Fr(proof.evaluations[name]).serialize()
    # prover_messages: 3 × ProverMsg::EmptyMessage (variant byte 0)
    out += struct.pack("<Q", 3) + b"\x00\x00\x00"
    # pc_proof: BatchLCProof { proof: Vec<kzg10::Proof>, evals: None }
    out += struct.pack("<Q", 2)
    for w, rand in ((proof.pc_proof_beta, proof.pc_rand_beta),
                    (proof.pc_proof_gamma, proof.pc_rand_gamma)):
        out += w.serialize_compressed()
        out += b"\x01" + Fr(rand).serialize()  # Option random_v (hiding on)
    out += b"\x00"  # evals: Option::None
    return bytes(out)


def deserialize_proof(data: bytes) -> MarlinProof:
    off = 0
    (n_rounds,) = struct.unpack_from("<Q", data, off)
    off += 8
    ensure(n_rounds == len(ROUND_GROUPS), "unexpected round-commitment count")
    commitments = {}
    for group in ROUND_GROUPS:
        (n_comms,) = struct.unpack_from("<Q", data, off)
        off += 8
        ensure(n_comms == len(group), "unexpected commitment count in round")
        for name in group:
            commitments[name], off = _read_commitment(data, off)
    (n_evals,) = struct.unpack_from("<Q", data, off)
    off += 8
    ensure(n_evals == len(ALL_EVALS), "unexpected evaluation count")
    evaluations = {}
    for name in ALL_EVALS:
        evaluations[name] = Fr.deserialize(data[off : off + 32]).value
        off += 32
    (n_msgs,) = struct.unpack_from("<Q", data, off)
    off += 8
    ensure(n_msgs == 3, "unexpected prover-message count")
    ensure(
        data[off : off + n_msgs] == b"\x00" * n_msgs,
        "prover messages must be EmptyMessage (variant byte 0)",
    )
    off += n_msgs
    (n_pc,) = struct.unpack_from("<Q", data, off)
    off += 8
    ensure(n_pc == 2, "expected two opening proofs (beta, gamma)")
    witnesses = []
    rands = []
    for _ in range(2):
        witnesses.append(G1Point.deserialize_compressed(data[off : off + 48]))
        off += 48
        has_rand = data[off]
        off += 1
        if has_rand:
            rands.append(Fr.deserialize(data[off : off + 32]).value)
            off += 32
        else:
            rands.append(0)
    return MarlinProof(
        commitments=commitments,
        evaluations=evaluations,
        pc_proof_beta=witnesses[0],
        pc_proof_gamma=witnesses[1],
        pc_rand_beta=rands[0],
        pc_rand_gamma=rands[1],
    )


def serialize_verifying_key(vk: IndexVerifierKey) -> bytes:
    """ark-marlin IndexVerifierKey field order: index info (u64s), the
    Vec of index commitments (indexer-polynomial order), then the
    marlin_pc VerifierKey fields (g, γG, h, βH,
    degree_bounds_and_shift_powers, max_degree).

    Index info is exactly ark's field set — num_variables,
    num_constraints, num_non_zero (ark-marlin 0.3 IndexInfo; the r4
    trailing num_instance u64 is gone: like ark, the verifier re-derives
    the input domain from the passed public input).  Domain sizes are
    derived on deserialization."""
    out = bytearray()
    out += struct.pack(
        "<3Q",
        vk.info.num_variables,
        vk.info.num_constraints,
        vk.info.num_non_zero,
    )
    out += struct.pack("<Q", len(INDEX_POLYS))
    for name in INDEX_POLYS:
        out += vk.index_commitments[name].serialize()
    out += vk.g.serialize_compressed()
    out += b"\x01" if vk.gamma_g is not None else b"\x00"
    if vk.gamma_g is not None:
        out += vk.gamma_g.serialize_compressed()
    out += vk.h.serialize_compressed()
    out += vk.beta_h.serialize_compressed()
    shift_powers = vk.shift_powers or {}
    out += b"\x01" if shift_powers else b"\x00"
    if shift_powers:
        out += struct.pack("<Q", len(shift_powers))
        for bound in sorted(shift_powers):
            out += struct.pack("<Q", bound)
            out += shift_powers[bound].serialize_compressed()
    out += struct.pack("<Q", vk.srs_max_degree)
    return bytes(out)


def deserialize_verifying_key(data: bytes) -> IndexVerifierKey:
    num_variables, num_constraints, num_non_zero = struct.unpack_from(
        "<3Q", data, 0
    )
    n = next_pow2(max(num_constraints, num_variables, 2))
    m = next_pow2(max(num_non_zero, 2))
    off = 24
    (n_comms,) = struct.unpack_from("<Q", data, off)
    off += 8
    ensure(n_comms == len(INDEX_POLYS), "unexpected index-commitment count")
    commitments = {}
    for name in INDEX_POLYS:
        commitments[name], off = _read_commitment(data, off)
    g = G1Point.deserialize_compressed(data[off : off + 48])
    off += 48
    gamma_g = None
    if data[off]:
        gamma_g = G1Point.deserialize_compressed(data[off + 1 : off + 49])
        off += 49
    else:
        off += 1
    h = G2Point.deserialize_compressed(data[off : off + 96])
    off += 96
    beta_h = G2Point.deserialize_compressed(data[off : off + 96])
    off += 96
    shift_powers = None
    if data[off]:
        off += 1
        (n_shift,) = struct.unpack_from("<Q", data, off)
        off += 8
        shift_powers = {}
        for _ in range(n_shift):
            (bound,) = struct.unpack_from("<Q", data, off)
            off += 8
            shift_powers[bound] = G1Point.deserialize_compressed(data[off : off + 48])
            off += 48
    else:
        off += 1
    (srs_max,) = struct.unpack_from("<Q", data, off)
    off += 8
    # num_instance is not part of ark's IndexInfo: the verifier derives
    # the input domain from the passed public input, and the prover from
    # the constraint system (marlin.index/prove fix these up from cs)
    info = IndexInfo(
        num_instance_padded=0,
        num_instance=0,
        domain_h_size=n,
        domain_k_size=m,
        max_degree=max(3 * n - 1, 3 * m - 3),
        num_variables=num_variables,
        num_constraints=num_constraints,
        num_non_zero=num_non_zero,
    )
    return IndexVerifierKey(
        info=info,
        index_commitments=commitments,
        g=g,
        h=h,
        beta_h=beta_h,
        srs_max_degree=srs_max,
        gamma_g=gamma_g,
        shift_powers=shift_powers,
    )


def serialize_proving_key(pk) -> bytes:
    """ProvingKey serde (reference serialization.rs:28-45): the u64-LE
    length of the vk and the vk; the twelve index polynomials, each a u64
    count and its coefficients as standard-form 32-byte LE Fr; the SRS
    powers (a u64 count, compressed); h, βH; the γ powers (a u64 count,
    compressed)."""
    out = bytearray()
    vk_bytes = serialize_verifying_key(pk.vk)
    out += struct.pack("<Q", len(vk_bytes))
    out += vk_bytes
    for mat in pk.index.matrices:
        for poly in (mat.row_poly, mat.col_poly, mat.val_poly, mat.row_col_poly):
            out += struct.pack("<Q", len(poly.vec))
            out += poly.vec.to_std_array().tobytes()
    srs = pk.srs
    out += struct.pack("<Q", srs.num_powers)
    out += b"".join(p.serialize_compressed() for p in srs.powers_of_g)
    out += srs.h.serialize_compressed()
    out += srs.beta_h.serialize_compressed()
    gamma_powers = srs.powers_of_gamma_g or []
    out += struct.pack("<Q", len(gamma_powers))
    out += b"".join(p.serialize_compressed() for p in gamma_powers)
    return bytes(out)


def deserialize_proving_key(data: bytes, device=None):
    """An IndexProverKey from :func:`serialize_proving_key`'s bytes, its SRS
    planes and index on ``device`` (the card by default); the K-domain
    evaluations are recomputed there."""
    device = resolve(device)
    (vk_len,) = struct.unpack_from("<Q", data, 0)
    off = 8
    vk = deserialize_verifying_key(data[off : off + vk_len])
    off += vk_len
    polys = []
    for _ in range(12):
        (n_coeffs,) = struct.unpack_from("<Q", data, off)
        off += 8
        std = np.frombuffer(data, dtype="<u8", count=4 * n_coeffs, offset=off)
        off += 32 * n_coeffs
        polys.append(DensePoly(FrVec.from_std_array(std.reshape(-1, 4), device)))
    (n_powers,) = struct.unpack_from("<Q", data, off)
    off += 8
    powers = [G1Point.deserialize_compressed(data[off + 48 * i : off + 48 * (i + 1)])
              for i in range(n_powers)]
    off += 48 * n_powers
    h = G2Point.deserialize_compressed(data[off : off + 96])
    beta_h = G2Point.deserialize_compressed(data[off + 96 : off + 192])
    off += 192
    gamma_powers = []
    if off < len(data):
        (n_gamma,) = struct.unpack_from("<Q", data, off)
        off += 8
        gamma_powers = [G1Point.deserialize_compressed(data[off + 48 * i : off + 48 * (i + 1)])
                        for i in range(n_gamma)]
    x, y, _z = g1_limb.points_to_limb_major_affine(powers, device)
    srs = UniversalSRS(torch.stack([x, y]), h, beta_h, gamma_powers)
    return IndexProverKey(index=index_from_polys(vk.info, polys), srs=srs, vk=vk)
