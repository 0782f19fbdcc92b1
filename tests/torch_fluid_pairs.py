"""Run one Fluid program in the JAX package and in the port from the same
starting values: the harness of ``test_torch_fluid_control_flow.py`` and
``test_torch_fluid_ops_rest.py``.

A builder ``fn(fl) -> (fetch_list, feeds)`` writes its program into
``fl``'s default programs (``fl`` is ``paddle_tpu.fluid`` or
``paddle_tpu_torch.fluid``) and returns what to fetch and a list of
feeds, one a step.  ``jax_side`` builds and runs it in the JAX package
(startup, then each step); ``port_side`` builds it in the port, loads the
JAX startup values into its scope and runs the same steps on the CPU.
"""

import json

import numpy as np


def program_json(prog) -> str:
    return json.dumps(prog.to_json_dict(), sort_keys=True)


def _names(fetch):
    return [v if isinstance(v, str) else v.name for v in fetch]


def jax_side(jfluid, builder) -> dict:
    """The JAX program's JSON (main and startup), startup values and each
    step's fetches."""
    jfluid.framework.reset_default_programs()
    fetch, feeds = builder(jfluid)
    main = jfluid.default_main_program()
    startup = jfluid.default_startup_program()
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    init = {k: np.array(v) for k, v in scope.vars.items()}
    steps = [[np.array(v) for v in exe.run(main, feed=f,
                                           fetch_list=_names(fetch),
                                           scope=scope)]
             for f in feeds]
    return dict(main=program_json(main), startup=program_json(startup),
                init=init, steps=steps, fetch=_names(fetch))


def port_side(tfluid, builder, init) -> dict:
    """The port's program JSON and each step's fetches from ``init``."""
    tfluid.framework.reset_default_programs()
    fetch, feeds = builder(tfluid)
    main = tfluid.default_main_program()
    startup = tfluid.default_startup_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe._step = 1                     # the JAX run's startup was step 0
    for k, v in init.items():
        scope.set(k, v)
    steps = [exe.run(main, feed=f, fetch_list=_names(fetch), scope=scope)
             for f in feeds]
    return dict(main=program_json(main), startup=program_json(startup),
                steps=steps, scope=scope, exe=exe, program=main)


def assert_steps_close(got, want, rtol, atol, name=""):
    """Every fetch of every step: integers equal, floats within
    (rtol, atol), shapes equal."""
    assert len(got) == len(want), name
    for s, (gs, ws) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(gs, ws)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, (name, s, j, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=f"{name} step {s} #{j}")
            else:
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"{name} step {s} #{j}")
