"""The kernel wrappers' share of their roofline, in %: the sum over every
wrapper call of the least time its work needs (``qbench/roofline.py``) over
the summed device time of the kernels launched inside those calls
(``torch.profiler``). None where no kernel ran on the device."""


def read(record):
    device_us = sum(record.get("kernel_device_us", {}).values())
    if device_us <= 0:
        return None
    return 100 * sum(record["kernel_bound_s"].values()) * 1e6 / device_us
