"""Marlin proof-system facade on the card.

Port of ``simpleworks_tpu/marlin/__init__.py`` (reference
``src/marlin/mod.rs``):

* ``generate_rand()`` — the deterministic test RNG
* ``universal_setup(nc, nv, nnz, rng, device=None)`` / ``generate_universal_srs``
* ``index(srs, cs)`` / ``generate_proving_and_verifying_keys``
* ``prove(pk, cs, rng)`` / ``generate_proof``
* ``verify(vk, public_inputs, proof, rng)`` / ``verify_proof``

The proof is the 3-round Marlin AHP (:mod:`.ahp`, :mod:`.prover`) over KZG10
with degree bounds (:mod:`simpleworks_tpu_torch.kzg.kzg10`), Fiat-Shamir via
Blake2s + ChaCha20.  Index and prove run on the SRS's device (the card
unless the setup named another); verify is host arithmetic and pairings.
The reference's proving-key disk checkpoint and its device routing
(``ops/accel.py``) are not ported.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..curves.bls12_377 import G1Point, G2Point
from ..fields.bls12_377 import FR_MODULUS, Fr
from ..hash.blake2s import blake2s_digest
from ..kzg import kzg10
from ..kzg.kzg10 import Commitment, UniversalSRS
from ..utils.observability import PROVER_TIMER
from ..utils.rng import test_rng
from . import ahp
from .fiat_shamir import FiatShamirRng

P = FR_MODULUS

#: ark-marlin's protocol label; the Fiat-Shamir rng is initialised from
#: PROTOCOL_NAME ‖ vk ‖ public input, as in ark-marlin's prove/verify
PROTOCOL_NAME = b"MARLIN-2019"

#: canonical query orderings shared by prover and verifier
BETA_POLYS = ["w", "z_a", "z_b", "mask", "t", "g_1", "h_1"]
#: ark-marlin 0.3's 12-polynomial index vocabulary (row, col, val, row_col
#: per matrix)
GAMMA_POLYS = [
    "g_2", "h_2",
    "row_a", "col_a", "val_a", "row_col_a",
    "row_b", "col_b", "val_b", "row_col_b",
    "row_c", "col_c", "val_c", "row_col_c",
]
INDEX_POLYS = GAMMA_POLYS[2:]
#: proof-evaluation order: sorted by label, for the proof and the transcript
EVALUATION_ORDER = sorted(BETA_POLYS + GAMMA_POLYS)


@dataclass
class IndexVerifierKey:
    info: ahp.IndexInfo
    index_commitments: dict[str, Commitment]
    g: G1Point
    h: G2Point
    beta_h: G2Point
    srs_max_degree: int
    gamma_g: Optional[G1Point] = None  # hiding-check generator γG
    #: τ^(D−d)·G per degree bound d: the verifier's adjusted-commitment check
    #: for g_1 and g_2
    shift_powers: Optional[dict[int, G1Point]] = None

    def transcript_bytes(self) -> bytes:
        """The vk's Fiat-Shamir contribution: num_variables, num_constraints,
        num_non_zero as u64 LE, then the 12 index commitments in
        INDEX_POLYS order."""
        meta = (
            self.info.num_variables.to_bytes(8, "little")
            + self.info.num_constraints.to_bytes(8, "little")
            + self.info.num_non_zero.to_bytes(8, "little")
        )
        return meta + b"".join(self.index_commitments[name].serialize() for name in INDEX_POLYS)

    def digest(self) -> bytes:
        return blake2s_digest(self.transcript_bytes())


@dataclass
class IndexProverKey:
    index: ahp.Index
    srs: UniversalSRS
    vk: IndexVerifierKey
    #: the prover's per-key device cache (:class:`.prover.DeviceIndex`)
    device_index: object = field(default=None, repr=False, compare=False)


@dataclass
class MarlinProof:
    commitments: dict[str, Commitment]
    evaluations: dict[str, int]
    pc_proof_beta: G1Point
    pc_proof_gamma: G1Point
    # combined blinding evaluations r(β), r(γ) of the hiding commitments
    pc_rand_beta: int = 0
    pc_rand_gamma: int = 0


def generate_rand():
    """reference src/marlin/mod.rs:33-35."""
    return test_rng()


def universal_setup(num_constraints: int, num_variables: int, num_non_zero: int, rng,
                    device=None) -> UniversalSRS:
    """The SRS for circuits up to these sizes, on ``device`` (the card by
    default)."""
    max_degree = ahp.max_degree_for(num_constraints, num_variables, num_non_zero)
    return kzg10.setup(max_degree, rng, device=device)


# reference alias (src/marlin/mod.rs:45-55)
def generate_universal_srs(num_constraints, num_variables, num_non_zero, rng, device=None):
    return universal_setup(num_constraints, num_variables, num_non_zero, rng, device=device)


#: index memo: ``index`` is deterministic given (srs, matrix content); keyed
#: by the srs object identity (kept alive by the cached pk) and a matrix
#: fingerprint
_INDEX_MEMO: dict = {}
_INDEX_MEMO_MAX = 4
#: guards the memo's check and insert (the proof pipeline indexes on one
#: thread while another proves); a key two threads both miss is built twice
_INDEX_MEMO_LOCK = threading.Lock()


def _matrix_fingerprint(cs, raw) -> bytes:
    h = hashlib.blake2s()
    h.update(b"%d,%d,%d" % (cs.num_instance_variables, cs.num_witness_variables,
                            cs.num_constraints))
    for rows, cols, coeffs in raw:
        h.update(repr(rows).encode())
        h.update(repr(cols).encode())
        h.update(repr(coeffs).encode())
    return h.digest()


def index(srs: UniversalSRS, cs) -> tuple[IndexProverKey, IndexVerifierKey]:
    """Arithmetize and commit the index polynomials on the SRS's device
    (reference MarlinInst::index).  Memoized on (srs identity, matrix
    content)."""
    with PROVER_TIMER.region("index.host.to_matrices"):
        raw = cs.to_matrices()
    with PROVER_TIMER.region("index.host.fingerprint"):
        memo_key = (id(srs), _matrix_fingerprint(cs, raw))
    with _INDEX_MEMO_LOCK:
        cached = _INDEX_MEMO.get(memo_key)
    if cached is not None:
        return cached
    with PROVER_TIMER.region("index.arithmetize"):
        idx = ahp.index_matrices(cs, raw=raw, device=srs.device)
    if idx.info.max_degree > srs.max_degree:
        raise ValueError(
            f"circuit too large for SRS: needs degree {idx.info.max_degree}, "
            f"SRS has {srs.max_degree}"
        )
    commitments: dict[str, Commitment] = {}
    with PROVER_TIMER.region("index.commit"):
        for mat, name in zip(idx.matrices, ["a", "b", "c"]):
            commitments[f"row_{name}"] = kzg10.commit(srs, mat.row_poly.vec.t)
            commitments[f"col_{name}"] = kzg10.commit(srs, mat.col_poly.vec.t)
            commitments[f"val_{name}"] = kzg10.commit(srs, mat.val_poly.vec.t)
            commitments[f"row_col_{name}"] = kzg10.commit(srs, mat.row_col_poly.vec.t)
    bounds = (idx.info.domain_h_size - 2, idx.info.domain_k_size - 2)
    vk = IndexVerifierKey(
        info=idx.info,
        index_commitments=commitments,
        g=srs.first_power(),
        h=srs.h,
        beta_h=srs.beta_h,
        srs_max_degree=srs.max_degree,
        gamma_g=srs.gamma_g if srs.powers_of_gamma_g else None,
        shift_powers={b: srs.power(srs.max_degree - b) for b in sorted(set(bounds))},
    )
    result = (IndexProverKey(index=idx, srs=srs, vk=vk), vk)
    with _INDEX_MEMO_LOCK:
        if len(_INDEX_MEMO) >= _INDEX_MEMO_MAX:
            _INDEX_MEMO.pop(next(iter(_INDEX_MEMO)))
        _INDEX_MEMO[memo_key] = result
    return result


# reference alias (src/marlin/mod.rs:88-94)
def generate_proving_and_verifying_keys(srs, cs):
    return index(srs, cs)


def _serialize_instance(instance: list[int]) -> bytes:
    return b"".join(Fr(v).serialize() for v in instance)


def _fixup_num_instance(info: ahp.IndexInfo, cs) -> None:
    """Restore the input-domain fields that the serialized IndexInfo omits,
    from the constraint system being proved."""
    if not info.num_instance:
        info.num_instance = cs.num_instance_variables
        info.num_instance_padded = ahp.next_pow2(cs.num_instance_variables)


def _degree_bounds(info: ahp.IndexInfo) -> dict[str, Optional[int]]:
    bounds: dict[str, Optional[int]] = {name: None for name in BETA_POLYS + GAMMA_POLYS}
    bounds["g_1"] = info.domain_h_size - 2
    bounds["g_2"] = info.domain_k_size - 2
    return bounds


def prove(pk: IndexProverKey, cs, rng=None) -> MarlinProof:
    """Three-round zk AHP + batched hiding KZG openings on the SRS's device
    (reference MarlinInst::prove).  ``rng`` supplies the zero-knowledge
    randomness; the deterministic test RNG by default."""
    from .prover import prove as prove_on_device

    with PROVER_TIMER.region("host.is_satisfied"):
        unsatisfied = cs.which_is_unsatisfied()
    if unsatisfied is not None:
        raise ValueError(f"constraint system unsatisfied at {unsatisfied}")
    if rng is None:
        rng = test_rng()
    return prove_on_device(pk, cs, rng)


def verify(vk: IndexVerifierKey, public_inputs: list[int], proof: MarlinProof, rng=None) -> bool:
    """reference MarlinInst::verify (src/marlin/mod.rs:79-86), on the host.

    ``public_inputs`` excludes the leading One: the instance is
    [1, *public_inputs]."""
    info = vk.info
    instance = [1] + [int(v) % P for v in public_inputs]
    bounds = _degree_bounds(info)

    fs = FiatShamirRng(PROTOCOL_NAME + vk.transcript_bytes() + _serialize_instance(instance))
    comms = proof.commitments
    try:
        fs.absorb(b"".join(comms[n].serialize() for n in ["w", "z_a", "z_b", "mask"]))
        alpha = fs.squeeze_field_element()
        etas = fs.squeeze_field_elements(3)
        fs.absorb(b"".join(comms[n].serialize() for n in ["t", "g_1", "h_1"]))
        beta = fs.squeeze_field_element()
        fs.absorb(b"".join(comms[n].serialize() for n in ["g_2", "h_2"]))
        gamma = fs.squeeze_field_element()
        evals = proof.evaluations
        fs.absorb(b"".join(Fr(evals[n]).serialize() for n in EVALUATION_ORDER))
        xi = fs.squeeze_field_element()
    except KeyError:
        return False

    if not ahp.verify_outer_sumcheck(info, instance, alpha, etas, beta, evals):
        return False
    if not ahp.verify_inner_sumcheck(info, alpha, beta, etas, gamma, evals["t"], evals):
        return False

    all_comms = dict(comms)
    all_comms.update(vk.index_commitments)
    for names, point, witness, random_v in (
        (BETA_POLYS, beta, proof.pc_proof_beta, proof.pc_rand_beta),
        (GAMMA_POLYS, gamma, proof.pc_proof_gamma, proof.pc_rand_gamma),
    ):
        batch = [(None, all_comms[n], evals[n], bounds[n]) for n in names]
        if not kzg10.batch_check(
            vk.g, vk.h, vk.beta_h, vk.srs_max_degree, batch, point, witness, xi,
            gamma_g=vk.gamma_g, random_v=random_v, shift_powers=vk.shift_powers,
        ):
            return False
    return True


# -- reference-parity aliases (fork API shape) ---------------------------------


def generate_proof(cs, proving_key: IndexProverKey, rng=None) -> MarlinProof:
    """reference src/marlin/mod.rs:70-77 (prove_from_constraint_system)."""
    return prove(proving_key, cs, rng)


def verify_proof(verifying_key: IndexVerifierKey, public_inputs, proof, rng=None) -> bool:
    """reference src/marlin/mod.rs:79-86."""
    return verify(verifying_key, public_inputs, proof, rng)
