"""The yardstick: the work counts behind prove_mfu and msm_roofline on
small shapes, and that they read the same work whatever engine proved."""

import numpy as np
import pytest
import torch

from conftest import TINY_CELL

from atlas_bench import cells, frozen_judge, inputs, work


def _brute_pippenger(n, bits=254):
    return min(-(-bits // c) * (n + 2 * (2 ** c - 1))
               + (-(-bits // c) - 1) * (c + 1) for c in range(1, 25))


@pytest.mark.parametrize("n", [1, 2, 3, 16, 1000, 1 << 14, 1 << 18])
def test_pippenger_at_its_best_window(n):
    assert work.pippenger_adds(n) == _brute_pippenger(n)
    # more points never cost fewer additions, and never more than
    # double-and-add's 1.5 * 254 a point beyond small n
    assert work.pippenger_adds(n + 1) >= work.pippenger_adds(n)
    if n >= 16:
        assert work.pippenger_adds(n) < 381 * n


def test_msm_bound_is_bound_by_its_imads():
    pk = work.peak("NVIDIA H100 80GB HBM3")
    assert pk["imad_per_s"] == pytest.approx(132 * 64 * 1.98e9)
    n = 1 << 17
    imad_s = work.msm_imads(n) / pk["imad_per_s"]
    assert work.msm_bound_s(n, pk) == imad_s > work.msm_bytes(n) / 3.35e12
    assert work.peak("an unknown card") is None


def test_sumcheck_and_proof_counts():
    assert work.sumcheck_products(1, 2) == 4
    assert work.sumcheck_products(10, 3) == 1023 * 9
    shapes = {"openings": [("A", "TanhRaD", 12), ("A", "TanhRaD", 12),
                           ("B", "RsqrtQuotient", 4)],
              "sumchecks": [(5, 2)], "reduction_degree": 2,
              "joint_vars": 3}
    adds = ((1 << 12) // 16 - 1) + work.pippenger_adds(16) \
        + work.pippenger_adds(2) + work.pippenger_adds(4) \
        + work.pippenger_adds(5)
    products = adds * 12 + 31 * 4 + 2 * 4095 * 4 + 15 * 4
    assert work.proof_imads(shapes) == products * 264


def _prove(root, **gates):
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.frontend.builder import ModelBuilder
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    cell = cells.find(root, TINY_CELL)
    cfg, builder = cell.config, cell.builder
    w = builder.weights(cfg, inputs.normals(builder.weight_shapes(cfg), 99,
                                            torch.device("cpu")))
    model = builder.build(ModelBuilder, cfg, w)
    prover = AtlasProver(AtlasPreprocessing.preprocess(model),
                         device="cpu", **gates)
    vocab, seq = builder.request(cfg)
    toks = np.arange(seq, dtype=np.int32) % vocab
    proof, io = prover.prove([toks])
    ok, shapes = frozen_judge.Judge(cell, w).verify(
        serde.serialize_proof(proof), toks,
        cell.reference.forward(cfg, w, toks))
    assert ok
    return shapes


def test_the_counts_do_not_change_with_the_engine(tiny_root):
    from jolt_atlas_tpu_torch.device import gate, reduction, rows
    host = _prove(tiny_root)
    engines = _prove(tiny_root, msm_gate=gate.forced("device"),
                     reduction_gate=reduction.forced(tail_rounds=1),
                     iop_gate=rows.forced(head_rounds=2, min_n=2))
    assert engines == host
    assert work.proof_imads(engines) == work.proof_imads(host) > 0
