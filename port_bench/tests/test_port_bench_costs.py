"""Operation and byte counts of the benchmark's rooflines against hand counts
at small shapes, and against the graph the configurations state."""

import pytest

from port_bench.harness import costs


def test_block_cost_by_hand():
    # n=2, t=4, v=3, cin=2, c=8, k=2, nnz=5, stride 2, projection residual
    # mix 4*3*2*2*8=384, adjacency 4*5*2=40, taps t_out=2: 2*3*9*8*8=3456,
    # SE 2*8*2=32, projection 2*3*2*8=96 -> 4008 MACs per window
    flops, nbytes = costs.block_cost(2, 4, 3, 2, 8, 2, 5, 2, "proj")
    assert flops == 2 * 2 * 4008
    # constants: A 18, mix 32+16, taps 576+8, scales/shifts 32, SE 32+2+8,
    # projection 16+16 -> 756; input 2*4*3*2=48, output 2*2*3*8=96
    assert costs.block_weights(3, 2, 8, 2, "proj") == 756
    assert nbytes == 4 * (48 + 96 + 756)


def test_block_cost_without_projection():
    flops, _ = costs.block_cost(1, 4, 3, 8, 8, 2, 5, 1, "identity")
    # mix 4*3*2*8*8=1536, adjacency 4*5*8=160, taps 4*3*9*64=6912, SE 2*8*2=32
    assert flops == 2 * (1536 + 160 + 6912 + 32)


def test_backbone_cost_by_hand():
    stages = [(8, 1, False), (8, 2, True)]
    flops, nbytes = costs.backbone_cost(2, 4, 3, 2, stages, 2, 5, 3)
    b1 = costs.block_cost(2, 4, 3, 2, 8, 2, 5, 1, "none")[0]
    b2 = costs.block_cost(2, 4, 3, 8, 8, 2, 5, 2, "proj")[0]
    # data BN 2*4*3*2, pool t_last=2: 2*3*8, head 2*8*3, per window
    assert flops == b1 + b2 + 2 * (2 * 4 * 3 * 2 + 2 * 3 * 8 + 2 * 8 * 3)
    weights = (2 * 3 * 2 + 8 * 3 + 3 + costs.block_weights(3, 2, 8, 2, "none")
               + costs.block_weights(3, 8, 8, 2, "proj"))
    assert nbytes == 4 * (2 * 4 * 3 * 2 + 2 * 3 + weights)


def test_the_graph_has_three_partitions_and_forty_nonzeros():
    assert costs.adjacency_counts() == (3, 40)


def test_forward_flops_of_the_configurations():
    stages = [[64, 1, False], [64, 1, True], [64, 1, True], [128, 2, True],
              [128, 1, True], [256, 2, True], [256, 1, True]]
    model = dict(family="stgcan", seq_len=30, num_joints=14, in_channels=3, stages=stages,
                 num_classes=11)
    single = costs.forward_flops(model, 3, 40)
    assert single == pytest.approx(2 * (costs.backbone_macs(30, 14, 3, stages, 3, 40) + 256 * 11))
    three = costs.forward_flops(dict(model, family="gstcan_3stream", num_classes=2,
                                     sensor_dim=4), 3, 40)
    sensor = 30 * 16 * 4 * 5 + 15 * 32 * 16 * 5 + 2 * 7 * 4 * 64 * (32 + 64) + 2 * 128 * 16 \
        + 128 * 2
    expect = 2 * (costs.backbone_macs(30, 14, 3, stages, 3, 40)
                  + costs.backbone_macs(29, 14, 2, stages, 3, 40) + sensor + 514 * 2)
    assert three == pytest.approx(expect)
    # one batch-128 flagship forward through K1: 163.4 GFLOP, 0.33 ms at 495 TFLOP/s
    k1 = sum(costs.block_cost(128, t, 14, ci, c, 3, 40, s, m)[0]
             for t0, cin in ((30, 3), (29, 2))
             for t, ci, c, s, m in costs.block_plan(t0, cin, stages))
    assert k1 == pytest.approx(163.407142912e9)


def test_roofline_takes_the_longer_bound():
    peak = costs.peaks("NVIDIA H100 80GB HBM3")
    assert peak == {"flops": 495e12, "bytes": 3.35e12}
    assert costs.roofline_ms(495e9, 1.0, peak) == pytest.approx(1.0)
    assert costs.roofline_ms(1.0, 3.35e9, peak) == pytest.approx(1.0)
    assert costs.peaks("some other card") is None
