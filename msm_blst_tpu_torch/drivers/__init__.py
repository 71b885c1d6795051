"""The measurement drivers (port of drivers/*.py): microbench (multiply-add,
matmul, Montgomery multiply and point-add rates), mxu_experiment (the SOS
multiply stage by stage) and gather_bench (gather formulations). Each is
run as `python -m msm_blst_tpu_torch.drivers.<name>` and prints one JSON
line per experiment."""
