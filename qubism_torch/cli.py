"""Command-line interface: file evaluation.

Counterpart of reference app/Main.hs: ``python -m qubism_torch file.qasm``
evaluates a file and prints "Done.". Ported flags: ``--seed``, ``--shots``,
``--dump-state``, ``--compile``, ``--fuse-width``, ``--mesh``,
``--reference-compat``, ``-I``, ``--include-base`` and ``--verbose``. Every
other flag of the JAX package's CLI (``--observable``, ``--backend``, ...),
and the REPL (no file), exit with code 2 and "not ported yet".
"""

from __future__ import annotations

import argparse
import sys

from .config import config
from .qasm.parser import QasmParseError, parse_openqasm
from .run.interpreter import run_program
from .run.progstate import ProgState, QasmRuntimeError


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qubism",
        description="OpenQASM 2.0 simulator on PyTorch/CUDA (file mode)",
    )
    p.add_argument("file", nargs="?", help="QASM file to evaluate")
    p.add_argument("--seed", type=int, default=None, help="PRNG seed for measurements")
    p.add_argument("--shots", type=int, default=None,
                   help="sample the final state this many times and print counts")
    p.add_argument("--dump-state", action="store_true",
                   help="print the final internal state (like a trailing :dump)")
    p.add_argument("--compile", action="store_true", dest="compile_mode",
                   help="run the program as fused segments of the compiled "
                        "engine (registers are laid out in one state vector "
                        "up front)")
    p.add_argument("--mesh", type=int, default=None, metavar="D",
                   help="run over a mesh of D GPUs (amplitude sharding with "
                        "device <-> local qubit-relabelling swaps); implies "
                        "--compile")
    p.add_argument("--fuse-width", type=int, default=5, metavar="K",
                   help="max qubits per fused dense block in --compile mode "
                        "(default 5; the kernels cap it at 4)")
    p.add_argument("--reference-compat", action="store_true",
                   help="replicate the reference's numerical quirks "
                        "(buggy u3, sqrt-Born sampling, truncated pi)")
    p.add_argument("-I", "--include-path", action="append", default=[],
                   metavar="DIR",
                   help="extra directory to search for include files "
                        "(after the includer-relative path; repeatable)")
    p.add_argument("--include-base", metavar="DIR", default=None,
                   help="directory REPL 'include' statements resolve against "
                        "(file mode resolves relative to the includer)")
    p.add_argument("--verbose", action="store_true",
                   help="per-statement timing to stderr")
    return p


def _apply_flags(args):
    if args.include_path:
        from .qasm import parser as _parser

        _parser.INCLUDE_PATH.extend(args.include_path)
    if args.verbose:
        from .utils import profiling

        profiling.VERBOSE = True
    if args.reference_compat:
        config.reference_u3_bug = True
        config.reference_sqrt_born = True
        config.reference_truncated_pi = True


def eval_file(path: str, seed: int | None = None, dump_state: bool = False,
              shots: int | None = None, out=None, source: str | None = None,
              inspect=None, compile_mode: bool = False, fuse_width: int = 5,
              mesh=None) -> int:
    """Evaluate a file (reference ``evalFile``, Main.hs:23-32). Returns the
    exit code. ``source``, when given, is parsed as the text of ``path``
    (includes resolve relative to it) instead of reading the file;
    ``inspect`` is called with the final :class:`ProgState` before "Done."
    (in compile mode, one state vector holding every register).
    ``compile_mode`` runs the program through
    :class:`~qubism_torch.run.compiler.CompiledProgram` with dense blocks of
    at most ``fuse_width`` qubits; ``mesh`` (a shard count or a device
    sequence) runs it sharded (:meth:`CompiledProgram.run_sharded`), and
    ``inspect`` then sees the cregs but no state vector. A mesh of more GPUs
    than the machine has exits 2."""
    out = out or sys.stdout
    if source is None:
        try:
            with open(path) as f:
                source = f.read()
        except OSError as e:
            print(f"qubism: {e}", file=out)
            return 2
    try:
        ast = parse_openqasm(path, source)
    except QasmParseError as e:
        out.write(e.pretty())
        return 1
    try:
        from .ops.apply import device

        device()
    except RuntimeError as e:
        print(f"qubism: {e}", file=out)
        return 2
    try:
        if mesh:
            from .run.compiler import CompiledProgram

            prog = CompiledProgram(ast, max_block=fuse_width)
            try:
                devices = prog.mesh_devices(mesh)
            except ValueError as e:
                print(f"qubism: --mesh {mesh}: {e}", file=out)
                return 2
            ps = _run_mesh(prog, devices, seed, dump_state, shots, out)
        elif compile_mode:
            from .run.compiler import CompiledProgram

            prog = CompiledProgram(ast, max_block=fuse_width)
            state, cregs, gen = prog.run(seed=seed, dump_writer=out.write)
            if dump_state:
                out.write(prog._pretty(state, cregs))
            ps = prog.prog_state(state, cregs, gen)
        else:
            ps = run_program(ast, seed=seed)
            if dump_state:
                out.write(ps.pretty())
        if shots and not mesh:  # a mesh run printed its own
            _print_shot_counts(ps, shots, out)
    except QasmRuntimeError as e:
        print(e, file=out)
        return 1
    if inspect is not None:
        inspect(ps)
    print("Done.", file=out)
    return 0


def _run_mesh(prog, devices, seed, dump_state, shots, out) -> ProgState:
    """Run a program over the mesh of ``devices``, print its dump and shot
    counts as the JAX package's --mesh path does; returns its cregs as a
    ProgState with no state vector."""
    import numpy as np

    from .utils.profiling import vlog

    sim, cregs, gen = prog.run_sharded(mesh=devices, seed=seed, dump_writer=out.write)
    if sim is not None:
        vlog(f"mesh run: {sim.D} device(s) x 2^{sim.w} bank(s), {sim.m} local "
             f"qubits/bank, {sim.dispatch_count} segments, swaps and measurements")
    if dump_state and prog.n:
        out.write(prog._pretty_for(prog.sim_state(sim), cregs))
    if shots and prog.n:
        vals, counts = np.unique(sim.sample(shots, gen), return_counts=True)
        print(f"Counts for state vector {prog.name} ({shots} shots):", file=out)
        for v, c in zip(vals, counts):
            print(f"  |{format(int(v), f'0{prog.n}b')}>: {int(c)}", file=out)
    return ProgState(cregs=dict(cregs), gen=gen)


def _print_shot_counts(ps: ProgState, shots: int, out):
    from .ops.sample import sample_counts

    for name in sorted(ps.stvecs):
        sv = ps.stvecs[name]
        counts = sample_counts(sv.state, sv.n, shots, ps.gen)
        print(f"Counts for state vector {name} ({shots} shots):", file=out)
        for basis in sorted(counts):
            print(f"  |{basis}>: {counts[basis]}", file=out)


def main(argv=None) -> int:
    args, rest = build_arg_parser().parse_known_args(argv)
    if rest:
        print(f"qubism: {' '.join(rest)}: not ported yet", file=sys.stderr)
        return 2
    if not args.file:
        print("qubism: the REPL (no file): not ported yet", file=sys.stderr)
        return 2
    _apply_flags(args)
    return eval_file(args.file, seed=args.seed, dump_state=args.dump_state,
                     shots=args.shots, compile_mode=args.compile_mode,
                     fuse_width=args.fuse_width, mesh=args.mesh)


if __name__ == "__main__":
    sys.exit(main())
