"""Example programs of the port, run with `python -m`: the PyTorch twins
of examples/fibers/run.py (`fibers_run`) and
examples/periodic_suspension/run.py (`periodic_suspension_run`)."""
