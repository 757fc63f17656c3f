"""The benchmark of ohm_tsd_slam_tpu_torch on one CUDA card
(`python slambench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`, cells in BENCHMARK.json)."""
