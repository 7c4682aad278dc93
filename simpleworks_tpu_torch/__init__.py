"""simpleworks_tpu_torch — the PyTorch/CUDA port of ``simpleworks_tpu``.

The port runs on one NVIDIA H100 (CUDA kernels for ``sm_90a``) and, at small
sizes, on the CPU through each kernel's plain PyTorch version.  It imports
torch, numpy and the standard library only — never JAX or the JAX package,
which stays beside it as the reference its tests hold it against.

Module paths mirror the JAX package:

* ``fields``  — host Fr/Fq (``host``, ``bls12_377``), the limb layout and
  packers (``device``), the device polynomial plane (``dvec``)
* ``curves``  — host G1/G2, the Fq tower and the pairing
* ``ops``     — the CUDA field kernels (``mont_mul``), G1 limb arithmetic
  (``g1_limb``), the device Pippenger MSM (``msm_pippenger``) and the SRS
  fixed-base powers (``srs_device``)
* ``kzg``     — KZG10 setup / commit / batch open / batch check
* ``hash``    — Blake2s, Poseidon (native and gadget), Pedersen and its gadget
* ``merkle``  — the Pedersen Merkle tree, its membership circuit and the
  self-proving ``SimpleMerkleTree``
* ``elgamal``, ``config`` — ElGamal over ed-on-bls12-377, the typed defaults
* ``examples`` — the reference workloads and their demo driver (``run``)
* ``utils``   — the ChaCha ``test_rng``
"""

__version__ = "0.1.0"
