"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(record):
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
