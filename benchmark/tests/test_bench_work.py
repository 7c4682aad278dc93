"""The roofline's yardstick against counts worked by hand."""

from benchmark.lib import work

# an Fq product: a multiply 2 * 12^2 = 288 multiply-adds, a squaring
# 12 * 13 / 2 + 12^2 = 222; a mixed add 7 * 288 + 4 * 222 = 2,904; an add
# 11 * 288 + 5 * 222 = 4,278
MADD, ADD = 2904, 4278


def test_product_counts():
    assert work.product_ops(12, 1, 0) == 288
    assert work.product_ops(12, 0, 1) == 222
    assert work.g1_ops(work.MIXED_ADD_PRODUCTS, 1) == MADD
    assert work.g1_ops(work.ADD_PRODUCTS, 1) == ADD
    assert work.g1_ops(work.ADD_PRODUCTS, 3) == 3 * ADD


def test_least_count_2p17():
    # c = 13: 20 windows, each 2^17 mixed adds and 2^14 adds
    n = 1 << 17
    assert work.pippenger_ops(n, 13) == 20 * (n * MADD + (1 << 14) * ADD) == 9_014_476_800
    assert work.least_pippenger(n) == (13, 9_014_476_800)


def test_least_count_2p20():
    # c = 15: 17 windows, each 2^20 mixed adds and 2^16 adds
    n = 1 << 20
    assert work.pippenger_ops(n, 15) == 17 * (n * MADD + (1 << 16) * ADD) == 56_532_271_104
    assert work.least_pippenger(n) == (15, 56_532_271_104)


def test_least_is_the_minimum_over_c():
    for n in (1 << 10, 1 << 17, 1 << 20, 1 << 26):
        c, ops = work.least_pippenger(n)
        assert ops == min(work.pippenger_ops(n, k) for k in range(1, 33))
        assert ops < work.pippenger_ops(n, c - 1) and ops <= work.pippenger_ops(n, c + 1)


def test_least_time():
    # 2^20 bases: 128 MiB at 3.35 TB/s is 0.040 ms; the operations at
    # 132 * 64 * 1.98 GHz take 3.380 ms, so they bound it
    t, bound = work.msm_least_ms(1 << 20, 1980.0)
    assert bound == "operations"
    assert abs(t - 56_532_271_104 / (132 * 64 * 1980e6) * 1e3) < 1e-12
    assert abs(t - 3.3797) < 1e-4
    assert work.msm_bytes(1 << 20) == 128 * (1 << 20)
