"""Host ms a program spends inside the run layer (``run_program``, or
``CompiledProgram`` built and run: the ``qbench.run`` spans), less the calls
into the CUDA runtime inside them that wait for the device (the
synchronising calls and the copies), over the traced window's programs."""

from qbench.trace import BLOCKING_PREFIXES, clip, union


def read(record):
    cpu = record.get("cpu", ())
    runs = union((s, e) for name, s, e in cpu if name == "qbench.run")
    if not runs or not record["programs"]:
        return None
    blocked = union((s, e) for name, s, e in cpu if name.startswith(BLOCKING_PREFIXES))
    waited = sum(e - s for r in runs for s, e in clip(blocked, *r))
    return (sum(e - s for s, e in runs) - waited) / 1e3 / record["programs"]
