"""train_samples_per_s: training rows consumed by the trainer's epochs
over the whole measured window."""


def read(run):
    return run.window.work["samples"] / run.window.seconds
