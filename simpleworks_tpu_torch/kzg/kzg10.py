"""KZG10 polynomial commitments with MarlinKZG-style degree bounds, over a
device-resident SRS.

Port of ``simpleworks_tpu/kzg/kzg10.py`` on the device plane that the JAX
package's device prover uses (``marlin/device_prover.py`` ``_commit_dev``
and ``_batch_open_dev``):

* setup: powers-of-tau SRS over G1, built on the device and normalised there
  to affine X/Y planes ``[2, 24, N]`` (on the CPU built by the native
  runtime's fixed base as normalised ``[N, 18]`` rows, which the SRS keeps
  beside its planes); H, βH in G2 and the γ powers on the host
* commit: device MSM of a ``[16, n]`` Montgomery coefficient tensor against
  the powers (for a CPU tensor the native runtime's batch-affine MSM over
  the host rows); a degree bound d adds a shifted commitment (the same
  coefficients against powers D−d onwards)
* batch open at z: one witness W = [Σ ξ^i (p_i(X)−p_i(z))/(X−z)]·G, combined
  and divided on the device; degree-bounded polys add their shifted quotient
* batch check (host): e(Σ ξ^i C_i − [Σ ξ^i v_i]·G − r(z)·γG, H) == e(W, βH − zH)

Hiding mode: a hiding commitment adds r(τ)·γG for a random blinding
polynomial r of degree 2, whose few coefficients stay host int lists.

Disk checkpoint: ``setup`` is deterministic given (max_degree, τ, γ), so
between its in-process memo and the build it looks for the table in a
per-machine cache of the port's own format (``torch_srs_*.npz``: the planes
as 16-bit limbs, H, βH and the γ powers compressed), and saves what it
builds there.  ``SWTPU_SRS_DISK_CACHE=0`` turns it off;
``SWTPU_SRS_CACHE_DIR`` names the directory (default
``swtpu_torch_srs_cache`` under ``tempfile.gettempdir()``).  A file saved
from one device loads onto any other.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import zipfile
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..curves.bls12_377 import G1Point, G2Point
from ..curves.fq_tower import Fq12
from ..curves.pairing import multi_pairing
from ..device import resolve
from ..errors import ensure
from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS, Fr
from ..fields.device import FR, mont_scalar
from .. import native
from ..ops import accel, g1_limb
from ..ops.msm_pippenger import msm_device_mont
from ..ops.srs_device import fixed_base_powers_affine
from .msm import FixedBaseMSM, msm

P = FR_MODULUS

#: degree of the blinding polynomials (hiding_bound = 1 opening per point,
#: +1 as in ark-poly-commit's ``Randomness::rand``)
HIDING_POLY_DEGREE = 2
#: γ-power table length: enough for blinding polys of degree HIDING_POLY_DEGREE
NUM_GAMMA_POWERS = HIDING_POLY_DEGREE + 1


class UniversalSRS:
    """Powers of tau [G, τG, τ²G, ...] as device-resident affine X/Y planes
    ``powers_xy`` [2, 24, N] (Z = 1, the identity as x = y = 0), plus H, τH
    and the γ powers [γG, τγG, ...] on the host.  An SRS on the CPU also
    holds the powers as the native runtime's normalised [N, 18] rows
    (:meth:`host_powers`), which its MSMs read."""

    def __init__(self, powers_xy: torch.Tensor, h: G2Point, beta_h: G2Point,
                 powers_of_gamma_g: list[G1Point], *, host_rows: Optional[np.ndarray] = None):
        if powers_xy.dim() != 3 or powers_xy.shape[:2] != (2, 24):
            raise ValueError(f"expected [2, 24, N] affine planes, got {tuple(powers_xy.shape)}")
        self.powers_xy = powers_xy
        self._host_rows = host_rows
        self._host_rows_lock = threading.Lock()
        self.h = h
        self.beta_h = beta_h
        self.powers_of_gamma_g = powers_of_gamma_g
        self._powers_list: Optional[list[G1Point]] = None

    @property
    def device(self) -> torch.device:
        return self.powers_xy.device

    @property
    def gamma_g(self) -> G1Point:
        return self.powers_of_gamma_g[0]

    @property
    def num_powers(self) -> int:
        return self.powers_xy.shape[2]

    @property
    def max_degree(self) -> int:
        return self.num_powers - 1

    @property
    def powers_of_g(self) -> list[G1Point]:
        """The powers as host points, read back from the planes once, on
        first use (1.57 M Python points at the bench's degree: the prover
        never asks for them)."""
        if self._powers_list is None:
            self._powers_list = g1_limb.points_from_affine_planes(self.powers_xy)
        return self._powers_list

    def device_powers(self) -> torch.Tensor:
        """The [2, 24, N] affine X/Y planes the device MSM reads."""
        return self.powers_xy

    def host_powers(self) -> np.ndarray:
        """The normalised [N, 18] u64 rows the native MSM reads (an SRS on
        the CPU only), made from the planes at the first call when the setup
        did not leave them."""
        ensure(self.device.type == "cpu", "host rows are kept for an SRS on the CPU only")
        with self._host_rows_lock:  # the pipeline's threads share one SRS
            if self._host_rows is None:
                self._host_rows = native.planes_to_native(self.powers_xy)
        return self._host_rows

    def power(self, i: int) -> G1Point:
        """τ^i·G, read back from the device."""
        return g1_limb.points_from_affine_planes(self.powers_xy[:, :, i : i + 1])[0]

    def first_power(self) -> G1Point:
        return self.power(0)


@dataclass
class Commitment:
    comm: G1Point
    shifted_comm: Optional[G1Point] = None
    degree_bound: Optional[int] = None

    def serialize(self) -> bytes:
        out = self.comm.serialize_compressed()
        out += b"\x01" if self.shifted_comm is not None else b"\x00"
        if self.shifted_comm is not None:
            out += self.shifted_comm.serialize_compressed()
        return out


#: in-process SRS memo: ``setup`` is deterministic given (max_degree, τ, γ)
#: and the device, and the rng is advanced identically on a hit (τ, γ are
#: drawn before the lookup), so reusing a table is unobservable
_SRS_MEMO: dict[tuple, UniversalSRS] = {}
_SRS_MEMO_MAX = 2
#: guards the memo's check and insert (the proof pipeline's threads share
#: it); a table two threads both miss is built twice, never half-stored
_SRS_MEMO_LOCK = threading.Lock()


def setup(max_degree: int, rng, device=None) -> UniversalSRS:
    """Sample τ, γ and build the powers tables on ``device`` (the card by
    default), or take them from the memo or the disk checkpoint."""
    device = resolve(device)
    tau = Fr.rand(rng).value
    gamma = Fr.rand(rng).value
    memo_key = (max_degree, tau, gamma, str(device))
    with _SRS_MEMO_LOCK:
        cached = _SRS_MEMO.get(memo_key)
    if cached is not None:
        return cached
    srs = _load_srs_disk(memo_key[:3], device)
    if srs is None:
        srs = _setup_uncached(max_degree, tau, gamma, device)
        _save_srs_disk(memo_key[:3], srs)
    with _SRS_MEMO_LOCK:
        if len(_SRS_MEMO) >= _SRS_MEMO_MAX:
            _SRS_MEMO.pop(next(iter(_SRS_MEMO)))
        _SRS_MEMO[memo_key] = srs
    return srs


# --------------------------------------------- disk checkpoint of the SRS --

#: the port's own file format (the reference's ``srs_*`` files never mix with
#: these: the prefixes differ, and so does each package's eviction)
_SRS_DISK_FORMAT = 1
_SRS_DISK_MAX_FILES = 4
_SRS_DISK_PREFIX = "torch_srs_"
#: errors of a missing, partial or foreign file: the load returns None
LOAD_ERRORS = (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile)


def _srs_disk_path(key) -> Optional[str]:
    """The checkpoint of (max_degree, τ, γ), or None when the cache is off."""
    if os.environ.get("SWTPU_SRS_DISK_CACHE") == "0":
        return None
    cache_dir = os.environ.get("SWTPU_SRS_CACHE_DIR",
                               os.path.join(tempfile.gettempdir(), "swtpu_torch_srs_cache"))
    tag = hashlib.sha256(repr((_SRS_DISK_FORMAT, *key)).encode()).hexdigest()[:24]
    return os.path.join(cache_dir, f"{_SRS_DISK_PREFIX}{key[0]}_{tag}.npz")


def save_npz_atomic(path: str, prefix: str, max_files: int, **arrays) -> None:
    """Write ``arrays`` to ``path`` through a temporary file and an atomic
    rename, first deleting the oldest ``prefix*.npz`` files of the directory
    so that at most ``max_files`` remain; an OSError leaves no file."""
    cache_dir = os.path.dirname(path)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        existing = sorted(
            (os.path.join(cache_dir, f) for f in os.listdir(cache_dir)
             if f.startswith(prefix) and f.endswith(".npz") and ".tmp." not in f),
            key=os.path.getmtime,
        )
        while len(existing) >= max_files:
            os.unlink(existing.pop(0))  # oldest first
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        pass


def _save_srs_disk(key, srs: UniversalSRS) -> None:
    path = _srs_disk_path(key)
    if path is None:
        return
    small = np.frombuffer(
        srs.h.serialize_compressed() + srs.beta_h.serialize_compressed()
        + b"".join(p.serialize_compressed() for p in srs.powers_of_gamma_g),
        dtype=np.uint8,
    )
    save_npz_atomic(path, _SRS_DISK_PREFIX, _SRS_DISK_MAX_FILES,
                    powers=srs.powers_xy.cpu().numpy().astype(np.uint16), small=small,
                    n_gamma=np.int64(len(srs.powers_of_gamma_g)))


def _load_srs_disk(key, device) -> Optional[UniversalSRS]:
    path = _srs_disk_path(key)
    if path is None:
        return None
    try:
        with np.load(path) as data:
            powers = data["powers"]
            small = data["small"].tobytes()
            n_gamma = int(data["n_gamma"])
    except LOAD_ERRORS:
        return None
    if powers.shape != (2, 24, key[0] + 1) or powers.dtype != np.uint16 \
            or len(small) != 192 + 48 * n_gamma:
        return None
    # upload 16 bits a limb (as int16), widen on the device
    planes = torch.from_numpy(powers.view(np.int16)).to(device).to(torch.int32) & 0xFFFF
    return UniversalSRS(
        planes,
        G2Point.deserialize_compressed(small[:96]),
        G2Point.deserialize_compressed(small[96:192]),
        [G1Point.deserialize_compressed(small[192 + 48 * i : 240 + 48 * i])
         for i in range(n_gamma)],
    )


@lru_cache(maxsize=1)
def _generator_table() -> FixedBaseMSM:
    """The generator's fixed-base table (8k host point adds), made once."""
    return FixedBaseMSM(G1Point.generator(), window_bits=8)


def _setup_uncached(max_degree: int, tau: int, gamma: int, device) -> UniversalSRS:
    g = G1Point.generator()
    h = G2Point.generator()
    beta_h = h.scalar_mul(tau)
    table = _generator_table()
    gamma_powers = [table.mul(gamma * pow(tau, i, P) % P) for i in range(NUM_GAMMA_POWERS)]
    if device.type == "cpu" and native.available():
        # the native fixed base over τ^0..τ^D, normalised to Z = 1
        tau_mont = native.ints_to_limbs64([tau * Fr.PARAMS.montgomery_r % P], 4)
        scalars = native.fr_from_mont_arr(native.fr_powers_arr(tau_mont, max_degree + 1))
        rows = native.g1_normalize_arr(native.g1_fixed_base_arr(g, scalars))
        return UniversalSRS(g1_limb.native_points_to_limb_major(rows, device), h, beta_h,
                            gamma_powers, host_rows=rows)
    # τ^0..τ^D built on the device (log-doubling), then out of Montgomery form
    tau_powers = dvec.to_standard(dvec.powers_vec(tau, max_degree + 1, device))
    powers_xy = fixed_base_powers_affine(g, tau_powers)
    return UniversalSRS(powers_xy, h, beta_h, gamma_powers)


def srs_from_reference(powers_native: np.ndarray, h_bytes: bytes, beta_h_bytes: bytes,
                       gamma_bytes: list[bytes], device=None) -> UniversalSRS:
    """The JAX package's SRS storage — its [N, 18] u64 Montgomery powers table
    (normalised to Z = 1) and compressed H, βH and γ powers — as the port's
    :class:`UniversalSRS`, so both packages can compute on one state."""
    return UniversalSRS(
        g1_limb.native_points_to_limb_major(powers_native, device),
        G2Point.deserialize_compressed(h_bytes),
        G2Point.deserialize_compressed(beta_h_bytes),
        [G1Point.deserialize_compressed(b) for b in gamma_bytes],
    )


# ------------------------------------------------- host blinding polynomials --


def _trim(coeffs: list[int]) -> list[int]:
    n = len(coeffs)
    while n and coeffs[n - 1] % P == 0:
        n -= 1
    return coeffs[:n]


def _poly_add_scaled(acc: list[int], coeffs: list[int], w: int) -> list[int]:
    out = acc + [0] * max(0, len(coeffs) - len(acc))
    for i, c in enumerate(coeffs):
        out[i] = (out[i] + c * w) % P
    return _trim(out)


def _poly_eval(coeffs: list[int], z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % P
    return acc


def _poly_div_linear(coeffs: list[int], z: int) -> list[int]:
    """Quotient of synthetic division by (X − z)."""
    if not coeffs:
        return []
    quot = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (carry * z + coeffs[i]) % P
        quot[i - 1] = carry
    return _trim(quot)


@dataclass
class Randomness:
    """Blinding polynomials (standard-form coefficient lists) of one hiding
    commitment and its shifted twin."""

    blind: list[int]
    shifted_blind: Optional[list[int]] = None

    @staticmethod
    def empty(has_shift: bool = False) -> "Randomness":
        """The zero blinding (a non-hiding commitment)."""
        return Randomness(blind=[], shifted_blind=[] if has_shift else None)

    @staticmethod
    def rand(rng, has_shift: bool = False) -> "Randomness":
        blind = _trim([Fr.rand(rng).value for _ in range(HIDING_POLY_DEGREE + 1)])
        shifted = (
            _trim([Fr.rand(rng).value for _ in range(HIDING_POLY_DEGREE + 1)])
            if has_shift
            else None
        )
        return Randomness(blind=blind, shifted_blind=shifted)


def _gamma_msm(srs: UniversalSRS, coeffs: list[int]) -> G1Point:
    ensure(len(coeffs) <= len(srs.powers_of_gamma_g), "blinding degree exceeds γ-table")
    return msm(srs.powers_of_gamma_g[: len(coeffs)], coeffs)


# -------------------------------------------------------- commit and open --

def host_msm(rows: np.ndarray, coeffs: torch.Tensor) -> G1Point:
    """The native batch-affine MSM of the [16, n] Montgomery coefficients (a
    CPU tensor) against the first n normalised [N, 18] ``rows``."""
    n = coeffs.shape[1]
    return native.g1_msm_affine_arr(rows[:n], native.std_words(coeffs))


def device_msm(points_xy: torch.Tensor, coeffs: torch.Tensor, offset: int = 0) -> G1Point:
    """MSM of the [16, n] Montgomery coefficients against points
    offset..offset+n of the [2, 24, N] affine planes, on their device: the
    device MSM on the card; for a CPU tensor the native MSM, or without the
    native runtime the pure-Python Pippenger (the reference's pure route).
    ``msm_device_mont`` on a CPU tensor, the kernels' oracle, is not a
    route."""
    n = coeffs.shape[1]
    if coeffs.device.type == "cpu":
        if native.available():
            return host_msm(native.planes_to_native(points_xy[:, :, offset : offset + n]),
                            coeffs)
        points = g1_limb.points_from_affine_planes(points_xy[:, :, offset : offset + n])
        return msm(points, dvec.to_ints(coeffs))
    return msm_device_mont(points_xy, coeffs, offset=offset)


def _srs_msm(srs: UniversalSRS, coeffs: torch.Tensor, offset: int = 0) -> G1Point:
    """MSM of the [16, n] Montgomery coefficients against SRS powers
    offset..offset+n: sharded over the prover's devices when they are set
    and n reaches the threshold (``ops.accel``), else :func:`device_msm`;
    on the CPU with the native runtime, over the SRS's host rows."""
    n = coeffs.shape[1]
    host = coeffs.device.type == "cpu" and native.available()
    if accel.use_sharded_msm(n):
        devices = accel.prover_devices()
        if devices is not None:
            from ..parallel import msm_sharded

            if host:
                return msm_sharded.sharded_msm_native(devices, srs.host_powers(),
                                                      native.std_words(coeffs), offset=offset)
            return msm_sharded.sharded_msm(devices, srs.powers_xy, coeffs, offset=offset)
    if host:
        return host_msm(srs.host_powers()[offset : offset + n], coeffs)
    return device_msm(srs.powers_xy, coeffs, offset=offset)


def true_width(poly: torch.Tensor) -> int:
    """1 + the degree of a [16, n] coefficient tensor (trailing zeros
    trimmed; 0 for the zero polynomial).  One small fetch."""
    nz = (poly != 0).any(dim=0).nonzero()
    return int(nz[-1]) + 1 if nz.numel() else 0


def commit(srs: UniversalSRS, poly: torch.Tensor, degree_bound: Optional[int] = None,
           hiding_rng=None) -> Commitment | tuple[Commitment, Randomness]:
    """Commit to the [16, n] Montgomery coefficient tensor ``poly`` (on the
    SRS's device); with ``hiding_rng`` the commitment is hiding and a
    ``(Commitment, Randomness)`` pair is returned.

    The degree checks use the true degree, trailing zeros trimmed, so a wide
    tensor with a zero tail commits as the host path allows."""
    n = true_width(poly)
    ensure(n - 1 <= srs.max_degree, "polynomial exceeds SRS degree")
    coeffs = poly[:, :n]
    c = _srs_msm(srs, coeffs) if n else G1Point.identity()
    rand = None
    if hiding_rng is not None:
        rand = Randomness.rand(hiding_rng, has_shift=degree_bound is not None)
        c = c.add(_gamma_msm(srs, rand.blind))
    shifted = None
    if degree_bound is not None:
        ensure(n - 1 <= degree_bound, f"polynomial degree {n - 1} exceeds bound {degree_bound}")
        shift = srs.max_degree - degree_bound
        shifted = _srs_msm(srs, coeffs, offset=shift) if n else G1Point.identity()
        if rand is not None:
            shifted = shifted.add(_gamma_msm(srs, rand.shifted_blind))
    comm = Commitment(comm=c, shifted_comm=shifted, degree_bound=degree_bound)
    return (comm, rand) if hiding_rng is not None else comm


def batch_open(
    srs: UniversalSRS,
    labeled: list[tuple[torch.Tensor, Commitment | None, int, Optional[int]]],
    point: int,
    xi: int,
    rands: Optional[list[Optional[Randomness]]] = None,
) -> tuple[G1Point, int]:
    """Combined witness for all polys (and shifted twins) at ``point``.

    ``labeled``: (coefficient tensor, commitment, value, degree bound) per
    polynomial.  Degree-bounded polys use marlin_pc's adjusted-commitment
    formulation: the shifted twin opens X^s·(p(X) − v) with claimed value 0,
    whose quotient X^s·q(X), q = (p − v)/(X − point), is an offset MSM over
    SRS powers s onwards.  The ξ-weight schedule (main term, then shifted
    term, per entry in order) is shared with :func:`batch_check`.

    Returns ``(W, random_v)``: the witness (G- and γ-components summed) and
    the combined blinding evaluation r(point) (0 when nothing is hiding)."""
    base_terms = []     # (weight, poly)
    shifted_terms = []  # (weight, poly, shift)
    blind_terms = []    # (weight, blinding coefficients)
    weight = 1
    for i, (poly, _comm, _value, bound) in enumerate(labeled):
        rand = rands[i] if rands is not None else None
        if rand is not None and rand.blind:
            blind_terms.append((weight, rand.blind))
        base_terms.append((weight, poly))
        weight = weight * xi % P
        if bound is not None:
            shifted_terms.append((weight, poly, srs.max_degree - bound))
            if rand is not None and rand.shifted_blind:
                blind_terms.append((weight, rand.shifted_blind))
            weight = weight * xi % P

    dev = srs.device
    max_len = max(int(p.shape[1]) for _, p in base_terms)
    if dev.type == "cpu" and native.available():
        # acc += Mont(c)·Mont(w)·R⁻¹, one axpy a polynomial on the host rows
        acc_words = np.zeros((max_len, 4), dtype="<u8")
        for w, poly in base_terms:
            if poly.shape[1]:
                native.fr_axpy_arr(acc_words, native.limbs_to_words(poly),
                                   native.limbs_to_words(mont_scalar(w, FR, dev)))
        acc = native.words_to_limbs(acc_words)
    else:
        acc = dvec.zeros(max_len, dev)
        for w, poly in base_terms:
            n = poly.shape[1]
            acc[:, :n] = dvec.add(acc[:, :n], dvec.scale(poly, mont_scalar(w, FR, dev)))
    combined_blind: list[int] = []
    for w, blind in blind_terms:
        combined_blind = _poly_add_scaled(combined_blind, blind, w)

    witness, _rem = dvec.divide_by_linear(acc, point)
    n = true_width(witness)
    w_point = _srs_msm(srs, witness[:, :n]) if n else G1Point.identity()
    for w, poly, shift in shifted_terms:
        quot, _rem = dvec.divide_by_linear(poly, point)
        n = true_width(quot)
        if n:
            scaled = dvec.scale(quot[:, :n], mont_scalar(w, FR, dev))
            w_point = w_point.add(_srs_msm(srs, scaled, offset=shift))
    random_v = 0
    if combined_blind:
        random_v = _poly_eval(combined_blind, point)
        blind_witness = _poly_div_linear(combined_blind, point)
        if blind_witness:
            w_point = w_point.add(_gamma_msm(srs, blind_witness))
    return w_point, random_v


def batch_check(
    srs_g: G1Point,
    h: G2Point,
    beta_h: G2Point,
    max_degree: int,
    labeled: list[tuple[None, Commitment, int, Optional[int]]],
    point: int,
    witness: G1Point,
    xi: int,
    gamma_g: Optional[G1Point] = None,
    random_v: int = 0,
    shift_powers: Optional[dict[int, G1Point]] = None,
) -> bool:
    """e(C_combined − v·G − r(z)·γG, H) == e(W, βH − zH) on the host.

    ``shift_powers`` maps each degree bound d to τ^(D−d)·G: the shifted
    commitment is adjusted to C' − v·τ^(D−d)·G and contributes claimed value
    0 — the verifier side of :func:`batch_open`'s offset quotient."""
    combined_c = G1Point.identity()
    combined_v = 0
    weight = 1
    for _poly, comm_obj, value, bound in labeled:
        ensure(comm_obj is not None, "batch check requires every commitment")
        combined_c = combined_c.add(comm_obj.comm.scalar_mul(weight))
        combined_v = (combined_v + weight * value) % P
        weight = weight * xi % P
        if bound is not None:
            ensure(comm_obj.shifted_comm is not None,
                   "degree-bounded commitment lacks its shifted part")
            ensure(shift_powers is not None and bound in shift_powers,
                   "degree-bound check requires the shift power in the verifying key")
            adjusted = comm_obj.shifted_comm
            if value % P:
                adjusted = adjusted.add(shift_powers[bound].scalar_mul(value % P).neg())
            combined_c = combined_c.add(adjusted.scalar_mul(weight))
            weight = weight * xi % P
    lhs = combined_c.add(srs_g.scalar_mul(combined_v).neg())
    if random_v % P:
        ensure(gamma_g is not None, "hiding check requires γG in the verifying key")
        lhs = lhs.add(gamma_g.scalar_mul(random_v % P).neg())
    beta_minus_z_h = beta_h.add(h.scalar_mul(point).neg())
    result = multi_pairing([(lhs, h), (witness.neg(), beta_minus_z_h)])
    return result == Fq12.one()
