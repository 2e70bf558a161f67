"""launches_per_batch.train: device kernels launched per training batch,
from the trace: the host's issue work."""


def read(run):
    t = run.trace
    return t.kernels / t.work["batches"]
