"""The port's disk checkpoints (the SRS in ``kzg10.setup``, the proving key in
``marlin.index``) and its proving-key serde, on the CPU.

A checkpoint is saved by one setup or index and loaded by the next once the
in-process memos are cleared, with no setup or index work (counted), and the
same planes and proof bytes; a truncated file rebuilds; with the switches at
0 nothing is written.  The serde's bytes equal the JAX package's for one
circuit on one state (its SRS carried over), and a key read back proves the
same bytes.  Tolerance 0."""

import os
import struct

import pytest
import torch

from simpleworks_tpu import marlin as ref_marlin
from simpleworks_tpu.examples import test_circuit as ref_test_circuit
from simpleworks_tpu.marlin import serialization as ref_serde
from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.examples import manual_constraints, test_circuit
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.marlin import serialization as serde

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

#: the smallest SRS that indexes test_circuit(3, 3) (n = 32, m = 64: degree 189)
SERDE_SIZES = (32, 32, 64)
#: the disk cases' SRS: degree 11, the manual circuit's (n = 4, m = 2)
DISK_SIZES = (4, 4, 4)


def clear_memos():
    kzg10._SRS_MEMO.clear()
    marlin._INDEX_MEMO.clear()


def point_caches(mp, root, on=True):
    """Both checkpoints on (or off), in ``root/srs`` and ``root/pk``."""
    for name in ("SWTPU_SRS_DISK_CACHE", "SWTPU_PK_DISK_CACHE"):
        if on:
            mp.delenv(name, raising=False)
        else:
            mp.setenv(name, "0")
    mp.setenv("SWTPU_SRS_CACHE_DIR", str(root / "srs"))
    mp.setenv("SWTPU_PK_CACHE_DIR", str(root / "pk"))


def setup_and_index():
    srs = marlin.universal_setup(*DISK_SIZES, marlin.generate_rand(), device=CPU)
    pk, vk = marlin.index(srs, manual_constraints.synthesize(3, 3))
    return srs, pk, vk


def files(root, prefix):
    return sorted(root.glob(f"*/{prefix}*.npz"))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A setup and an index with both checkpoints on, from empty memos: the
    files they wrote, and their SRS, key and proof bytes."""
    root = tmp_path_factory.mktemp("checkpoints")
    with pytest.MonkeyPatch.context() as mp:
        point_caches(mp, root)
        clear_memos()
        srs, pk, vk = setup_and_index()
        proof = serde.serialize_proof(marlin.prove(pk, manual_constraints.synthesize(3, 3)))
    clear_memos()
    return root, srs, pk, vk, proof


@pytest.fixture
def counts(monkeypatch):
    """Calls of the SRS build and of the index's commits; memos empty before
    and after."""
    seen = {"setup": 0, "commit": 0}
    setup, commit = kzg10._setup_uncached, kzg10.commit

    def counted_setup(*args):
        seen["setup"] += 1
        return setup(*args)

    def counted_commit(*args, **kwargs):
        seen["commit"] += 1
        return commit(*args, **kwargs)

    monkeypatch.setattr(kzg10, "_setup_uncached", counted_setup)
    monkeypatch.setattr(kzg10, "commit", counted_commit)
    clear_memos()
    yield seen
    clear_memos()


def copy_files(src, dst):
    for path in files(src, "torch_"):
        target = dst / path.parent.name / path.name
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(path.read_bytes())


def test_checkpoints_save_then_load_with_no_work(saved, counts, monkeypatch, tmp_path):
    root, srs, pk, vk, proof = saved
    assert [p.parent.name for p in files(root, "torch_srs_")] == ["srs"]
    assert [p.parent.name for p in files(root, "torch_pk_")] == ["pk"]
    copy_files(root, tmp_path)
    point_caches(monkeypatch, tmp_path)
    srs2, pk2, vk2 = setup_and_index()  # a second process: only the files are left
    assert counts == {"setup": 0, "commit": 0}
    assert srs2 is not srs and torch.equal(srs2.powers_xy, srs.powers_xy)
    assert srs2.powers_xy.dtype == torch.int32 and srs2.device == CPU
    assert (srs2.h, srs2.beta_h, srs2.powers_of_gamma_g) == (srs.h, srs.beta_h,
                                                             srs.powers_of_gamma_g)
    assert serde.serialize_verifying_key(vk2) == serde.serialize_verifying_key(vk)
    assert pk2.index.info == pk.index.info
    for m1, m2 in zip(pk.index.matrices, pk2.index.matrices):
        for name in ("row_poly", "col_poly", "val_poly", "row_col_poly"):
            assert torch.equal(getattr(m1, name).vec.t, getattr(m2, name).vec.t), name
        for name in ("row_evals", "col_evals", "val_evals", "row_col_evals"):
            assert torch.equal(getattr(m1, name).t, getattr(m2, name).t), name
    proof2 = marlin.prove(pk2, manual_constraints.synthesize(3, 3))
    assert serde.serialize_proof(proof2) == proof
    assert marlin.verify(vk2, [3], proof2)
    assert len(files(tmp_path, "torch_")) == 2  # nothing more written


def reuse_table(monkeypatch, srs):
    """The SRS build replaced by the saved table (the build itself is held
    to the reference in tests/test_torch_kzg.py); counted."""
    built = []
    monkeypatch.setattr(kzg10, "_setup_uncached", lambda *args: built.append(args) or srs)
    return built


def test_truncated_checkpoints_rebuild(saved, counts, monkeypatch, tmp_path):
    root, srs, pk, *_ = saved
    copy_files(root, tmp_path)
    for path in files(tmp_path, "torch_"):
        data = path.read_bytes()
        path.write_bytes(data[: len(data) // 2])
    point_caches(monkeypatch, tmp_path)
    built = reuse_table(monkeypatch, srs)
    _srs2, pk2, _ = setup_and_index()
    assert len(built) == 1 and counts["commit"] == 12  # both rebuilt, and saved again
    assert serde.serialize_verifying_key(pk2.vk) == serde.serialize_verifying_key(pk.vk)
    assert [p.read_bytes() for p in files(tmp_path, "torch_")] == \
        [p.read_bytes() for p in files(root, "torch_")]


def test_switches_off_write_nothing(saved, counts, monkeypatch, tmp_path):
    point_caches(monkeypatch, tmp_path, on=False)
    built = reuse_table(monkeypatch, saved[1])
    setup_and_index()
    assert len(built) == 1 and counts["commit"] == 12
    assert not (tmp_path / "srs").exists() and not (tmp_path / "pk").exists()


@pytest.fixture(scope="module")
def serde_keys():
    """test_circuit(3, 3) indexed by both packages on one SRS(32, 32, 64)
    (the JAX package's setup, carried over), with no disk checkpoint."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("SWTPU_SRS_DISK_CACHE", "SWTPU_PK_DISK_CACHE"):
            mp.setenv(name, "0")
        mp.setenv("SWTPU_DEVICE_PROVER", "0")
        ref_srs = ref_marlin.universal_setup(*SERDE_SIZES, ref_marlin.generate_rand())
        ref_pk, _ = ref_marlin.index(ref_srs, ref_test_circuit.synthesize(3, 3))
        ref_bytes = ref_serde.serialize_proving_key(ref_pk)
        srs = kzg10.srs_from_reference(
            ref_srs.powers_native, ref_srs.h.serialize_compressed(),
            ref_srs.beta_h.serialize_compressed(),
            [g.serialize_compressed() for g in ref_srs.powers_of_gamma_g], device=CPU)
        pk, vk = marlin.index(srs, test_circuit.synthesize(3, 3))
        yield ref_bytes, pk, vk
    marlin._INDEX_MEMO.clear()


def test_proving_key_bytes_match_reference(serde_keys):
    """The bytes of tests/test_reference_vectors.py's layout: a u64 LE vk
    length and the vk, twelve u64-counted polynomials of 32-byte Fr, the
    u64-counted compressed powers, h, βH, the u64-counted γ powers."""
    ref_bytes, pk, vk = serde_keys
    blob = serde.serialize_proving_key(pk)
    assert blob == ref_bytes
    (vk_len,) = struct.unpack_from("<Q", blob, 0)
    assert 0 < vk_len < len(blob) and blob[8 : 8 + vk_len] == serde.serialize_verifying_key(vk)
    off = 8 + vk_len
    for mat in pk.index.matrices:
        for poly in (mat.row_poly, mat.col_poly, mat.val_poly, mat.row_col_poly):
            (n_coeffs,) = struct.unpack_from("<Q", blob, off)
            assert n_coeffs == len(poly.vec)
            off += 8 + 32 * n_coeffs
    (n_powers,) = struct.unpack_from("<Q", blob, off)
    assert n_powers == pk.srs.num_powers == 190
    off += 8 + 48 * n_powers + 192
    (n_gamma,) = struct.unpack_from("<Q", blob, off)
    assert n_gamma == len(pk.srs.powers_of_gamma_g) and off + 8 + 48 * n_gamma == len(blob)


def test_deserialized_key_proves_the_same_bytes(serde_keys, saved):
    """A key read back from its bytes serializes to them again, on the
    device it was asked for; the manual circuit's key (SRS of degree 11:
    12 powers to decompress) read back proves the original key's bytes."""
    _ref_bytes, pk, _vk = serde_keys
    blob = serde.serialize_proving_key(pk)
    pk2 = serde.deserialize_proving_key(blob, device=CPU)
    assert pk2.srs.device == CPU and torch.equal(pk2.srs.powers_xy, pk.srs.powers_xy)
    assert pk2.srs.powers_of_gamma_g == pk.srs.powers_of_gamma_g
    assert serde.serialize_proving_key(pk2) == blob
    _root, _srs, manual_pk, manual_vk, proof = saved
    manual = serde.deserialize_proving_key(serde.serialize_proving_key(manual_pk), device=CPU)
    got = marlin.prove(manual, manual_constraints.synthesize(3, 3))
    assert serde.serialize_proof(got) == proof
    assert marlin.verify(manual_vk, [3], got)
    assert kzg10.Randomness.empty().blind == [] and kzg10.Randomness.empty(True).shifted_blind == []
    assert pk.srs.powers_of_g[5] == pk.srs.power(5) and pk.srs.device_powers() is pk.srs.powers_xy
