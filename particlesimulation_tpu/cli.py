"""Command-line driver with the reference's exact output contract.

Usage mirrors the reference binary (reference serial/parsim.cpp:461-469):

    python -m particlesimulation_tpu <seed> <side_length> <grid_size> \
        <n_particles> <n_timesteps> [--engine parity|fast] [--mesh N|RxC]

stdout: two lines — particle 0's position at three decimals, then the
cumulative collision count (serial/parsim.cpp:450-453). Wall time goes to
stderr as "%.1fs" (serial/parsim.cpp:475-479), timing only the step loop, as
the reference does; the fast engine first names its census route there
("route: impl=... kcap=..."). The reference bash harnesses can drive this
entry unmodified.
"""

from __future__ import annotations

import sys
import time


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    engine_kind = "parity"
    mesh = 1
    mesh_shape = ()
    impl = None
    pos_args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--engine":
            engine_kind = argv[i + 1]
            i += 2
        elif a == "--mesh":
            # "N" = 1D row decomposition over N devices; "RxC" = 2D
            # rectangular decomposition (parallel/sharded2d.py).
            mesh_arg = argv[i + 1]
            if "x" in mesh_arg:
                d_r, d_c = (int(v) for v in mesh_arg.split("x", 1))
                mesh_shape = (d_r, d_c)
                mesh = d_r * d_c
            else:
                mesh = int(mesh_arg)
            i += 2
        elif a == "--impl":
            impl = argv[i + 1]
            i += 2
        else:
            pos_args.append(a)
            i += 1
    if len(pos_args) != 5:
        print(
            "Usage: python -m particlesimulation_tpu <seed> <side_length> "
            "<grid_size> <n_particles> <n_timesteps> "
            "[--engine parity|fast] [--mesh N|RxC] "
            "[--impl resident|dense|sweep|banded|supercell|tiered] "
            "(mesh impls: resident|sweep|banded|banded-cyclic|supercell; "
            "default: census auto-route)",
            file=sys.stderr,
        )
        return 1

    mesh_str = ("x".join(str(v) for v in mesh_shape)
                if mesh_shape else str(mesh))
    reexec_args = pos_args + ["--engine", engine_kind, "--mesh", mesh_str]
    if impl is not None:
        reexec_args += ["--impl", impl]
    if engine_kind == "parity":
        # Parity needs CPU + x64 + no-FMA codegen; may re-exec this process.
        from particlesimulation_tpu.utils import runtime
        runtime.ensure_parity_runtime(
            "particlesimulation_tpu", reexec_args,
            n_cpu_devices=max(mesh, 1),
        )

    import jax

    if mesh > 1:
        # CPU mesh runs self-provision a virtual CPU mesh (the reference's
        # mpirun-on-one-machine analog, reference mpi/run_tests.sh:8-16);
        # on an accelerator with too few devices this raises instead.
        from particlesimulation_tpu.utils import runtime
        runtime.ensure_device_count("particlesimulation_tpu", reexec_args,
                                    mesh)

    from particlesimulation_tpu.config import Precision, SimConfig

    seed = int(pos_args[0])
    side = float(pos_args[1])
    ncside = int(pos_args[2])
    n_particles = int(pos_args[3])
    n_steps = int(pos_args[4])

    precision = Precision.PARITY if engine_kind == "parity" else Precision.FAST
    config = SimConfig(seed=seed, side=side, ncside=ncside,
                       n_particles=n_particles, precision=precision,
                       n_shards=mesh, mesh_shape=mesh_shape)

    if mesh_shape and mesh > 1:
        # With no --impl flag the 2D engine census-routes too: clustered
        # and sparse loads delegate to the 1D ring (banded-cols /
        # supercell) over the same devices; uniform loads stay on the
        # rectangle decomposition (round 5).
        from particlesimulation_tpu.parallel.sharded2d import Sharded2DEngine
        eng = Sharded2DEngine(config, mesh_shape, impl=impl)
    elif mesh > 1:
        from particlesimulation_tpu.parallel.sharded import ShardedEngine
        # Parity precision always runs the sweep slab impl (ShardedEngine
        # forces it); in fast precision --impl selects
        # resident|sweep|banded|banded-cyclic|supercell, and no --impl
        # census auto-routes exactly like the single chip (round 5).
        eng = ShardedEngine(config, impl=impl)
    else:
        from particlesimulation_tpu.engine import Engine
        eng = Engine(config, impl=impl)

    state = eng.init_state()
    # Warm-up compile outside the timed region (the reference's timer brackets
    # only simulate(); XLA's one-time compile is the analog of g++'s).
    state0 = eng.run(state, 0)
    t0 = time.perf_counter()
    state = eng.run(state0, n_steps)
    elapsed = time.perf_counter() - t0

    x, y, cols = eng.result(state)
    if engine_kind == "fast":
        # The census route the run took (stderr keeps stdout's contract).
        print(f"route: impl={eng.impl} kcap={getattr(eng, 'kcap', None)}",
              file=sys.stderr)
    print(f"{elapsed:.1f}s", file=sys.stderr)
    print(f"{x:.3f} {y:.3f}")
    print(cols)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
