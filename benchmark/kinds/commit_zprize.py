"""Kind ``commit_zprize``: the ``commit`` request (``kzg10.commit`` on the
next of a ring of ``ring`` polynomials of ``width`` coefficients, made on
the device from the seed) at ZPrize's scale, with a check of its own.

``correct``: every commitment of the window against the plain reference,
which evaluates p(tau) in two levels of blocks of ``kzg_wide.BLOCK``
coefficients (``reference/kzg_wide.py``: two tables of ``BLOCK`` and
``width / BLOCK`` powers of tau instead of ``width``), and the SRS's last
power with 15 drawn from the seed."""

from __future__ import annotations

from benchmark.kinds.commit import Kind as Commit
from benchmark.lib import seeds


class Kind(Commit):
    def check(self, records: list) -> dict:
        from benchmark.reference import g1, kzg, kzg_wide

        srs_sample = self.sample_srs()
        self.srs = None  # the program's state, before the reference
        tau, _ = kzg.setup_scalars(seeds.WordStream(self.seed, "srs").next_u64)
        srs_bad = sum(not g1.equal(pt, kzg.srs_power(tau, i)) for i, pt in srs_sample)
        width = self.ring.shape[2]
        tables = kzg_wide.power_tables(tau, width)
        expected = {}
        for k in sorted({k for k, _ in records}):
            expected[k] = kzg_wide.commitment(self.ring[k].cpu().numpy(), tables)
        bad = sum(not g1.equal(pt, expected[k]) for k, pt in records)
        return {"commit_mismatches": (bad, 0), "srs_power_mismatches": (srs_bad, 0),
                "_compared": {"commits": len(records), "srs_powers": len(srs_sample)}}
