"""Command-line interface: file evaluation and the QASM REPL.

Counterpart of reference app/Main.hs: ``python -m qubism_torch file.qasm``
evaluates a file and prints "Done."; with no file it starts a ``QASM> ``
REPL where the parser's symbol table and the simulator state persist across
lines and a failing line leaves both untouched (atomic lines,
Main.hs:39-57). ``:q`` quits, ``:obs PAULI`` prints an expectation,
``:save PATH`` / ``:load PATH`` checkpoint the session, ``:cd DIR`` rebases
``include``.

Flags: ``--seed``, ``--shots``, ``--dump-state``, ``--dtype``, ``--compile``,
``--fuse-width``, ``--mesh``, ``--observable`` (repeatable), ``--noise`` with
``--trajectories`` and ``--traj-engine vmap|fused|auto`` (noisy trajectories:
counts over the classical registers, ``--observable`` as mean +- stderr,
``--mesh D`` splitting the batch), ``--backend density`` with ``--noise``
(the exact density engine, on one device or over ``--mesh D``),
``--backend stabilizer`` (the Clifford tableau engine: ``--shots``,
``--dump-state``, ``--observable``; with ``--noise`` / ``--trajectories``
noisy Clifford trajectories on Pauli frames or tableaux), ``--backend mps``
with ``--chi``, ``--trunc-budget`` and ``--max-chi`` (the matrix-product-state
engine; with ``--noise`` / ``--trajectories`` noisy MPS trajectories),
``--reference-compat``, ``-I``, ``--include-base`` and ``--verbose``: every
flag of the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import config
from .qasm.parser import (
    ParserState,
    QasmParseError,
    initial_state,
    parse_openqasm,
    parse_openqasm_incremental,
)
from .run.interpreter import Interpreter, run_program
from .run.progstate import ProgState, QasmRuntimeError, blank_state


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qubism",
        description="OpenQASM 2.0 simulator on PyTorch/CUDA (file mode or REPL)",
    )
    p.add_argument("file", nargs="?", help="QASM file to evaluate; omit for a REPL")
    p.add_argument("--seed", type=int, default=None, help="PRNG seed for measurements")
    p.add_argument("--shots", type=int, default=None,
                   help="sample the final state this many times and print counts")
    p.add_argument("--dump-state", action="store_true",
                   help="print the final internal state (like a trailing :dump)")
    p.add_argument("--dtype", choices=["complex64", "complex128"], default=None,
                   help="requested amplitude precision. The engine stores "
                        "amplitudes as one complex64 tensor; complex128 is "
                        "rejected (the CUDA kernels are written for float2)")
    p.add_argument("--backend",
                   choices=["statevector", "stabilizer", "mps", "density"],
                   default="statevector",
                   help="simulation engine: the dense state-vector engine "
                        "(default; with --noise it runs noisy trajectories), "
                        "the Clifford stabilizer-tableau engine (1000+ "
                        "qubits; with --noise, Pauli-channel trajectories), "
                        "the matrix-product-state engine (bounded-entanglement "
                        "circuits at 100+ qubits, see --chi; with --noise, MPS "
                        "trajectories) or the exact density-matrix engine "
                        "(open-system: combine with --noise; 4^n amplitudes, "
                        "n <= 14 on one device, shard past that with "
                        "--mesh)")
    p.add_argument("--chi", type=int, default=32, metavar="X",
                   help="MPS bond dimension cap (--backend mps): simulation "
                        "is exact while the circuit's entanglement fits "
                        "(default 32)")
    p.add_argument("--trunc-budget", type=float, default=None, metavar="W",
                   help="adaptive MPS bond dimension (--backend mps, "
                        "non-trajectory runs): start at --chi and DOUBLE it "
                        "whenever an apply would push the accumulated "
                        "truncation weight past W (roll back and retry), up "
                        "to --max-chi; exceeding the budget at --max-chi "
                        "errors instead of returning a wrong spectrum")
    p.add_argument("--max-chi", type=int, default=256, metavar="X",
                   help="adaptive-chi growth ceiling for --trunc-budget "
                        "(default 256)")
    p.add_argument("--noise", metavar="SPEC", default=None,
                   help="circuit-level noise model, e.g. 'depolarizing:0.01' "
                        "or 'ad:0.05,pd:0.02' (channels: depolarizing, "
                        "amplitude-damping/ad, phase-damping/pd, bitflip/bf, "
                        "phaseflip/pf, dep2: 2q depolarizing after every "
                        "2-qubit gate, readout/ro: a reporting flip at "
                        "measurement); gate channels apply to every qubit a "
                        "gate touches. Runs the program as noisy trajectories, "
                        "or exactly with --backend density")
    p.add_argument("--trajectories", type=int, default=None, metavar="T",
                   help="run the program as T independent trajectories "
                        "(default: --shots, else 512), each with its own "
                        "mid-circuit outcomes")
    p.add_argument("--traj-engine", choices=["vmap", "fused", "auto"], default="vmap",
                   help="trajectory executor: 'vmap' (default; the whole batch "
                        "by batched torch ops, the same outcomes with --mesh "
                        "at a seed), 'fused' (each trajectory through the "
                        "CUDA kernels with realized operands: mixture noise, "
                        "MCWF damping, mid-circuit measurement and "
                        "feed-forward; errors on ineligible programs), 'auto' "
                        "(fused when eligible)")
    p.add_argument("--observable", action="append", default=[],
                   metavar="PAULI",
                   help="print <P> for a Pauli string over the declared "
                        "qubits (e.g. ZZI; repeatable)")
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
    if args.dtype == "complex128":
        raise SystemExit(
            "qubism: complex128 amplitudes are not supported: the engine "
            "stores one complex64 tensor, and the CUDA kernels in "
            "qubism_torch/csrc are written for float2 amplitudes")
    if args.reference_compat:
        config.reference_u3_bug = True
        config.reference_sqrt_born = True
        config.reference_truncated_pi = True


def eval_file(path: str, seed: int | None = None, dump_state: bool = False,
              shots: int | None = None, out=None, source: str | None = None,
              inspect=None, compile_mode: bool = False, fuse_width: int = 5,
              mesh=None, observables=(), backend: str = "statevector",
              noise: str | None = None, trajectories: int | None = None,
              traj_engine: str = "vmap", chi: int = 32,
              trunc_budget: float | None = None, max_chi: int = 256) -> int:
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
    than the machine has exits 2. ``observables`` are Pauli strings over the
    declared qubits; each prints ``<P> = value``. ``backend="density"`` runs
    the exact density engine (:class:`~qubism_torch.run.noisy.DensityProgram`)
    under the ``noise`` spec, on one device or sharded over ``mesh``;
    ``inspect`` then sees ``(rho, cregs)``. ``backend="stabilizer"`` runs
    the tableau engine (:class:`~qubism_torch.stabilizer.StabilizerProgram`;
    ``inspect`` sees ``(sim, cregs)``; a ``mesh`` exits 2), ``backend="mps"``
    the matrix-product-state engine (:class:`~qubism_torch.mps.MPSProgram`
    at bond cap ``chi``, growing it under ``trunc_budget`` up to
    ``max_chi``; ``inspect`` sees ``(sim, cregs)``; a ``mesh`` exits 2, a
    prim wider than 2 qubits or a broken budget exits 1). ``noise`` or
    ``trajectories`` runs ``trajectories`` noisy trajectories
    (:class:`~qubism_torch.run.noisy.TrajectoryProgram`, by ``traj_engine``,
    :class:`~qubism_torch.stabilizer.StabilizerTrajectoryProgram` on the
    stabilizer backend, :class:`~qubism_torch.mps.MPSTrajectoryProgram` at
    ``chi`` on the mps backend; the batch split over ``mesh``) and prints
    the counts over the classical registers and each observable as mean +-
    stderr; ``inspect`` is not called."""
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
        if backend == "density":
            rc, ps = _run_density(ast, noise, mesh, compile_mode or trajectories,
                                  seed, dump_state, shots, observables, out)
            if rc:
                return rc
        elif noise is not None or trajectories is not None:
            rc = _run_trajectories(ast, noise, trajectories, traj_engine, mesh,
                                   compile_mode, seed, shots, observables, out, backend, chi)
            if rc:
                return rc
            print("Done.", file=out)
            return 0
        elif backend == "stabilizer":
            from .stabilizer import NotCliffordError, StabilizerProgram

            rc, ps = _run_sim_program(backend, lambda: StabilizerProgram(ast),
                                      NotCliffordError, mesh, seed, dump_state, shots,
                                      observables, out)
            if rc:
                return rc
        elif backend == "mps":
            from .mps import MPSProgram, NotAdjacentError

            rc, ps = _run_sim_program(
                backend, lambda: MPSProgram(ast, chi=chi, trunc_budget=trunc_budget,
                                            max_chi=max_chi),
                (NotAdjacentError, FloatingPointError), mesh, seed, dump_state, shots,
                observables, out)
            if rc:
                return rc
        elif mesh:
            from .run.compiler import CompiledProgram

            prog = CompiledProgram(ast, max_block=fuse_width)
            try:
                devices = prog.mesh_devices(mesh)
            except ValueError as e:
                print(f"qubism: --mesh {mesh}: {e}", file=out)
                return 2
            ps, sim = _run_mesh(prog, devices, seed, dump_state, shots, out)
            if observables and prog.n:
                rc = _print_observables(observables, sim.expectation, out)
                if rc:
                    return rc
        elif compile_mode:
            from .run.compiler import CompiledProgram

            prog = CompiledProgram(ast, max_block=fuse_width)
            state, cregs, gen = prog.run(seed=seed, dump_writer=out.write)
            if dump_state:
                out.write(prog._pretty(state, cregs))
            ps = prog.prog_state(state, cregs, gen)
            if shots:
                _print_shot_counts(ps, shots, out)
            if observables and prog.n:
                from .ops.measure import expectation_pauli

                rc = _print_observables(
                    observables, lambda p_: expectation_pauli(state, prog.n, p_), out)
                if rc:
                    return rc
        else:
            ps = run_program(ast, seed=seed)
            if dump_state:
                out.write(ps.pretty())
            if shots:
                _print_shot_counts(ps, shots, out)
            if observables and ps.qregs:
                rc = _print_observables(
                    observables, lambda p_: _interp_expectation(ps, p_), out)
                if rc:
                    return rc
    except QasmRuntimeError as e:
        print(e, file=out)
        return 1
    if inspect is not None:
        inspect(ps)
    print("Done.", file=out)
    return 0


def _run_trajectories(ast, noise, trajectories, traj_engine, mesh, compile_mode, seed,
                      shots, observables, out, backend="statevector", chi=32) -> int:
    """Trajectory mode: run the program as noisy trajectories (Clifford
    ones on the stabilizer backend, MPS ones on the mps backend), print the
    counts over the classical registers and the observables as mean +-
    stderr, as the JAX package's CLI does. Returns the exit code."""
    from .mps import MPSTrajectoryProgram, NotAdjacentError
    from .run.noisy import TrajectoryProgram, resolve_traj_mesh
    from .run.traj_fused import FusedUnsupported
    from .stabilizer import NotCliffordError, StabilizerTrajectoryProgram

    if compile_mode:
        print("qubism: --noise/--trajectories is its own execution mode; drop --compile",
              file=out)
        return 2
    # --mesh in trajectory mode splits the BATCH over devices (trajectories
    # are embarrassingly parallel; no amplitude sharding)
    try:
        resolve_traj_mesh(mesh)
        if backend == "stabilizer":
            prog = StabilizerTrajectoryProgram(ast, noise=noise)
        elif backend == "mps":
            prog = MPSTrajectoryProgram(ast, noise=noise, chi=chi)
        else:
            prog = TrajectoryProgram(ast, noise=noise)
    except ValueError as e:
        print(f"qubism: {e}", file=out)
        return 2
    ntraj = trajectories or shots or 512
    if not prog.n or (not prog.creg_names and not observables):
        print("qubism: trajectory mode reports classical-register counts; the program "
              "declares none (add a creg or --observable)", file=out)
        return 2
    dense = type(prog) is TrajectoryProgram
    if traj_engine == "fused" and (mesh is not None or not dense):
        # the fused engine has no mesh path and no stabilizer form: an
        # explicit request errors
        why = "--mesh" if mesh is not None else type(prog).__name__
        print(f"qubism: --traj-engine fused is incompatible with {why}", file=out)
        return 2
    try:
        kw = {"engine": traj_engine} if dense and mesh is None else {"mesh": mesh}
        counts = prog.counts(ntraj, seed=seed, **kw) if prog.creg_names else {}
    except FusedUnsupported as e:
        print(f"qubism: --traj-engine fused: {e} (drop the flag or use --traj-engine auto)",
              file=out)
        return 2
    except NotCliffordError as e:
        print(f"qubism: stabilizer trajectories: {e}", file=out)
        return 1
    except NotAdjacentError as e:
        print(f"qubism: mps trajectories: {e}", file=out)
        return 1
    if prog.creg_names:
        print(f"Counts over classical registers ({ntraj} trajectories):", file=out)
        for row in sorted(counts):
            print(f"  {row}: {counts[row]}", file=out)
    if observables:
        # every observable reduces on one trajectory run
        memo = {}

        def compute(p_):
            if not memo:
                ups = [o.upper() for o in observables]
                memo.update(zip(ups, prog.expectations(ups, ntraj, seed=seed, mesh=mesh)))
            return memo[p_]

        return _print_observables(observables, compute, out)
    return 0


def _run_density(ast, noise, mesh, compile_mode, seed, dump_state, shots, observables,
                 out):
    """The exact density backend: run the program, print its dump, shot
    counts and observables as the JAX package's ``--backend density`` does.
    Returns (exit code, (rho, cregs)). ``compile_mode`` (or trajectories)
    is refused."""
    import torch

    from .run.noisy import DensityProgram

    if compile_mode:
        print("qubism: --backend density is exact (no compile/trajectories)", file=out)
        return 2, None
    try:
        prog = DensityProgram(ast, noise=noise, mesh=mesh)
        # the shape of a sharded rho is validated when it is allocated
        rho, cregs = prog.run(seed=seed, dump_writer=out.write)
    except ValueError as e:
        print(f"qubism: {e}", file=out)
        return 2, None
    if dump_state:
        out.write(prog._pretty(rho, cregs))
    if shots and prog.n:
        gen = torch.Generator().manual_seed(0 if seed is None else seed)
        _print_basis_counts(rho.sample(shots, gen), "(x)".join(prog.layout), shots, out)
    if observables and prog.n:
        rc = _print_observables(observables, rho.expectation, out)
        if rc:
            return rc, None
    return 0, (rho, cregs)


def _run_sim_program(backend, make, errors, mesh, seed, dump_state, shots, observables, out):
    """The stabilizer and mps backends in file mode: run the program that
    ``make()`` builds (a StabilizerProgram or an MPSProgram), print its
    dump, shot counts and observables as the JAX package's ``--backend``
    does; ``errors`` (a non-Clifford gate, an unroutable prim, a broken
    truncation budget) exit 1. Returns (exit code, (sim, cregs))."""
    if mesh:
        print("qubism: --mesh applies to the state-vector and density backends", file=out)
        return 2, None
    prog = make()
    try:
        sim, cregs = prog.run(seed=seed, dump_writer=out.write)
    except errors as e:
        print(f"qubism: {backend} backend: {e}", file=out)
        return 1, None
    if dump_state:
        out.write(prog._pretty(sim, cregs))
    if shots and prog.n:
        _print_basis_counts(_sampled_bit_counts(sim.sample(shots)), "(x)".join(prog.layout),
                            shots, out)
    if observables and prog.n:
        rc = _print_observables(observables, sim.expectation, out)
        if rc:
            return rc, None
    return 0, (sim, cregs)


def _sampled_bit_counts(bits):
    """(shots, n) 0/1 sample rows -> Counter of basis bitstrings."""
    import collections

    return collections.Counter("".join("01"[b] for b in row) for row in bits)


def _run_mesh(prog, devices, seed, dump_state, shots, out):
    """Run a program over the mesh of ``devices``, print its dump and shot
    counts as the JAX package's --mesh path does; returns (its cregs as a
    ProgState with no state vector, the ShardedSim or None)."""
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
    return ProgState(cregs=dict(cregs), gen=gen), sim


def _print_shot_counts(ps: ProgState, shots: int, out):
    from .ops.sample import sample_counts

    for name in sorted(ps.stvecs):
        sv = ps.stvecs[name]
        _print_basis_counts(sample_counts(sv.state, sv.n, shots, ps.gen), name, shots, out)


def _print_basis_counts(counts, name, shots, out):
    """The ``Counts for state vector ...`` block shared by the shots paths;
    ``counts`` maps basis bitstring -> count."""
    print(f"Counts for state vector {name} ({shots} shots):", file=out)
    for basis in sorted(counts):
        print(f"  |{basis}>: {counts[basis]}", file=out)


def _print_observables(observables, compute, out) -> int:
    """Print one ``<P> = value`` line per --observable; ``compute(pauli)``
    returns a float or a (mean, stderr) pair. Returns 0 on success, 2 on a
    rejected Pauli string, 1 on a non-Clifford gate met by the stabilizer
    trajectories or a prim the MPS trajectories cannot route (the exit code
    their counts give)."""
    from .mps import NotAdjacentError
    from .stabilizer import NotCliffordError

    for pauli in observables:
        try:
            val = compute(pauli.upper())
        except NotCliffordError as e:
            print(f"qubism: stabilizer trajectories: {e}", file=out)
            return 1
        except NotAdjacentError as e:
            print(f"qubism: mps trajectories: {e}", file=out)
            return 1
        except ValueError as e:
            print(f"qubism: --observable: {e}", file=out)
            return 2
        if isinstance(val, tuple):
            print(f"<{pauli.upper()}> = {val[0]:.6f} +- {val[1]:.6f}", file=out)
        else:
            print(f"<{pauli.upper()}> = {float(val):.6f}", file=out)
    return 0


def _interp_expectation(ps: ProgState, pauli: str) -> float:
    """<P> on the interpreter's lazily fused state: the global state is a
    tensor product of clusters (ProgState.stvecs), so <P> factorizes into
    the product of per-cluster expectations. Qubit order = qreg declaration
    order, matching the compiled layout."""
    from .ops.measure import _check_pauli

    slots = [(qr.target, qr.start + k)
             for qr in ps.qregs.values() for k in range(qr.size)]
    pauli = _check_pauli(pauli, len(slots))
    per: dict = {}
    for (tgt, local), c in zip(slots, pauli):
        per.setdefault(tgt, {})[local] = c
    val = 1.0
    for tgt, assign in per.items():
        sv = ps.stvecs[tgt]
        s = "".join(assign.get(i, "I") for i in range(sv.n))
        if set(s) != {"I"}:
            val *= sv.expectation(s)
    return val


class Repl:
    """The QASM REPL: incremental parse + incremental run, atomic lines."""

    PROMPT = "QASM> "

    def __init__(self, seed: int | None = None, out=None,
                 include_base: str | None = None):
        # REPL lines have no source file, so 'include' resolves relative to
        # ``include_base`` (default: the current directory). A pseudo file
        # path inside that directory makes the includer-relative rule do the
        # work; ':cd DIR' rebases it mid-session.
        base = os.path.abspath(include_base or os.getcwd())
        self.pstate: ParserState = initial_state(os.path.join(base, "<repl>"))
        self.prog: ProgState = blank_state(seed)
        self.out = out or sys.stdout

    def line(self, text: str) -> bool:
        """Process one input line. Returns False when the REPL should exit."""
        stripped = text.strip()
        if stripped == ":q":
            return False
        if stripped == ":cd" or stripped.startswith(":cd "):
            arg = stripped[3:].strip()
            base = os.path.abspath(arg or os.getcwd())
            if not os.path.isdir(base):
                print(f"qubism: :cd: no such directory: {base}", file=self.out)
                return True
            self.pstate = ParserState(dict(self.pstate.id_table),
                                      os.path.join(base, "<repl>"))
            print(f"include base: {base}", file=self.out)
            return True
        if stripped.startswith(":save ") or stripped.startswith(":load "):
            return self._checkpoint_cmd(stripped)
        if stripped.startswith(":observable ") or stripped.startswith(":obs "):
            pauli = stripped.split(None, 1)[1].rstrip(";").strip()
            try:
                val = _interp_expectation(self.prog, pauli.upper())
            except ValueError as e:
                print(f"qubism: :observable: {e}", file=self.out)
                return True
            print(f"<{pauli.upper()}> = {val:.6f}", file=self.out)
            return True
        try:
            ast, pstate2 = parse_openqasm_incremental(self.pstate, text)
        except QasmParseError as e:
            self.out.write(e.pretty())
            return True
        # the appliers work in place: the line runs on a copy that owns its
        # tensors, and replaces the kept state only when all of it succeeded
        new = self.prog.copy()
        interp = Interpreter(new, dump_writer=self.out.write)
        try:
            for stmt in ast:
                interp.run_stmt(stmt)
            interp.flush()  # materialize the line's trailing unitary run
        except QasmRuntimeError as e:
            print(e, file=self.out)
            return True  # discard: both parser and program state stay put
        self.pstate = pstate2
        self.prog = new
        return True

    def _checkpoint_cmd(self, stripped: str) -> bool:
        """``:save <path>`` / ``:load <path>``: checkpoint/resume the full
        session (simulator state + parser symbol table)."""
        from .utils.checkpoint import load_progstate, save_progstate

        cmd, _, path = stripped.partition(" ")
        path = path.strip()
        try:
            if cmd == ":save":
                save_progstate(self.prog, path, self.pstate)
                print(f"Saved session to {path}", file=self.out)
            else:
                ps, pstate = load_progstate(path)
                if ps.gen is None:  # a file of the JAX package: keep ours
                    ps.gen = self.prog.gen
                self.prog = ps
                if pstate is not None:
                    self.pstate = pstate
                print(f"Loaded session from {path}", file=self.out)
        except OSError as e:
            print(f"qubism: {e}", file=self.out)
        return True

    def run(self, infile=None):
        infile = sys.stdin if infile is None else infile
        while True:
            self.out.write(self.PROMPT)
            self.out.flush()
            raw = infile.readline()
            if raw == "":  # EOF
                self.out.write("\n")
                return
            if not self.line(raw.rstrip("\n")):
                return


def main(argv=None) -> int:
    args, rest = build_arg_parser().parse_known_args(argv)
    if rest:
        print(f"qubism: {' '.join(rest)}: not ported yet", file=sys.stderr)
        return 2
    _apply_flags(args)
    if args.file:
        return eval_file(args.file, seed=args.seed, dump_state=args.dump_state,
                         shots=args.shots, compile_mode=args.compile_mode,
                         fuse_width=args.fuse_width, mesh=args.mesh,
                         observables=args.observable, backend=args.backend,
                         noise=args.noise, trajectories=args.trajectories,
                         traj_engine=args.traj_engine, chi=args.chi,
                         trunc_budget=args.trunc_budget, max_chi=args.max_chi)
    try:
        from .ops.apply import device

        device()
    except RuntimeError as e:
        print(f"qubism: {e}", file=sys.stderr)
        return 2
    Repl(seed=args.seed, include_base=args.include_base).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
