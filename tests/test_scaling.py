"""Scaling-harness floor (VERDICT r1 item 2): sharded batched replay on the
virtual CPU mesh must not crater total throughput.

An 8-device virtual mesh oversubscribes a small CPU host, so per-device
"efficiency" is meaningless here; the invariant that IS meaningful is that
sharding 8 sequences over 8 virtual devices keeps total throughput within a
constant factor of the 1-device run (i.e. the sharded program adds no
serialization/dispatch pathology). The >= 80% 1 -> 4 card efficiency is
measured on the GPUs (`python -m sosvo.dist.scaling` there).
"""

from sosvo.dist.scaling import measure_scaling


def test_cpu_mesh_sharded_replay_keeps_total_throughput(devices8):
    rep = measure_scaling(device_counts=[1, 8], n_frames=4, k=128,
                          seqs_per_device=1, n_landmarks=1024)
    rows = {r["devices"]: r for r in rep["rows"]}
    total_1 = rows[1]["frames_per_s"]
    total_8 = rows[8]["frames_per_s"]
    # Fixed host compute divided 8 ways: total throughput must stay within
    # 2.5x of the single-device run (measured ~1.0x; the floor catches a
    # sharding-induced serialization, not host jitter).
    assert total_8 > 0.4 * total_1, (total_1, total_8)
