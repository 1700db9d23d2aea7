"""The byte and operation bounds against counts made by hand."""

import pytest

from portbench.harness import bounds


def test_normal_apply_by_hand():
    # 2 blocks of 3 x 4: A 2·12·4 B, x 2·4·4 B, u 2·4·4 B, q 2·3·4 B
    b = bounds.normal_apply(2, 3, 4)
    assert b.nbytes == 96 + 32 + 32 + 24
    assert b.flops == 4 * 2 * 3 * 4


def test_blockdiag_apply_by_hand():
    # A read, x (4 a block) read, y (3 a block) written
    b = bounds.blockdiag_apply(2, 3, 4)
    assert b.nbytes == 96 + 32 + 24
    assert b.flops == 2 * 2 * 3 * 4


def test_poststack_apply_by_hand():
    # model read once, data and two gradient components written once
    assert bounds.poststack_apply(10).nbytes == 10 * 4 + 3 * 10 * 4


def test_main_path_numbers():
    # 128 blocks of 4096²: the bytes bound the time, 2.56 ms at 3.35 TB/s
    b = bounds.normal_apply(128, 4096, 4096)
    assert b.seconds() == pytest.approx((128 * 4096 ** 2 * 4
                                         + 128 * 3 * 4096 * 4) / 3.35e12)
    assert b.seconds() == pytest.approx(2.5645e-3, rel=1e-3)
    # one forward and one adjoint of [W D; ε ∇] at 65536 x 1024: 2.15 GB
    p = bounds.poststack_apply(65536 * 1024)
    assert 2 * p.nbytes == pytest.approx(2.147e9, rel=1e-3)


def test_operations_bound_a_narrow_call():
    b = bounds.Bound(nbytes=1.0, flops=67e12)
    assert b.seconds() == pytest.approx(1.0)
