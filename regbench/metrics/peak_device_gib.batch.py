"""Peak device memory allocated over the window, the fullest card, GiB."""


def read(run):
    t = run.trace
    return None if t is None else t.peak_bytes / 2 ** 30
