"""Kind ``commit``: ``kzg10.commit(srs, poly)`` (non-hiding, no degree bound)
on the next of a ring of ``ring`` polynomials of ``width`` coefficients,
made on the device from the seed; the commitment ends on the host.

``correct``: every commitment of the window against the plain reference
(the seed gives τ, so a commitment to p is [p(τ)]G), and the SRS's last
power with 15 drawn from the seed."""

from __future__ import annotations

from benchmark.lib import seeds
from benchmark.lib.generator import Traffic, jacobian
from benchmark.reference import field


class Kind(Traffic):
    def setup(self) -> None:
        import torch

        from simpleworks_tpu_torch.kzg import kzg10

        self.mark("program import")
        width, ring = int(self.mix["width"]), int(self.mix["ring"])
        if width - 1 > self.config["max_degree"]:
            raise ValueError(f"width {width} exceeds the SRS degree {self.config['max_degree']}")
        self.srs = kzg10.setup(self.config["max_degree"], seeds.WordStream(self.seed, "srs"),
                               device=self.device)
        self.mark("srs")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, "ring"))
        polys = torch.randint(0, 1 << 16, (ring, 16, width), dtype=torch.int32,
                              generator=gen, device=self.device)
        # values below (r >> 240) * 2^240 < r, each top coefficient nonzero
        polys[:, 15] %= field.R >> 240
        polys[:, 0, width - 1] |= 1
        self.ring = polys
        self.mark("ring")

    def warm(self) -> None:
        from simpleworks_tpu_torch.kzg import kzg10

        kzg10.commit(self.srs, self.ring[0])

    def request(self, i: int):
        from simpleworks_tpu_torch.kzg import kzg10

        return kzg10.commit(self.srs, self.ring[i % self.ring.shape[0]])

    def record(self, i: int, out):
        return (i % self.ring.shape[0], jacobian(out.comm))

    def sample_srs(self) -> list:
        """The SRS powers the reference checks: the last, and 15 drawn from
        the seed, read back from the program's SRS."""
        top = self.srs.max_degree
        picks = sorted(set(seeds.WordStream(self.seed, "srs-sample").integers(0, top, 15)) | {top})
        return [(i, jacobian(self.srs.power(i))) for i in picks]

    def check(self, records: list) -> dict:
        from benchmark.reference import g1, kzg

        srs_sample = self.sample_srs()
        self.srs = None  # the program's state, before the reference
        tau, _ = kzg.setup_scalars(seeds.WordStream(self.seed, "srs").next_u64)
        srs_bad = sum(not g1.equal(pt, kzg.srs_power(tau, i)) for i, pt in srs_sample)
        width = self.ring.shape[2]
        x_limbs = kzg.power_limbs(tau, width)
        expected = {}
        for k in sorted({k for k, _ in records}):
            expected[k] = kzg.commitment(self.ring[k].cpu().numpy(), x_limbs)
        bad = sum(not g1.equal(pt, expected[k]) for k, pt in records)
        return {"commit_mismatches": (bad, 0), "srs_power_mismatches": (srs_bad, 0),
                "_compared": {"commits": len(records), "srs_powers": len(srs_sample)}}
