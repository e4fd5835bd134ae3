"""Traffic kinds: each module's ``Runner`` turns a traffic file of its
kind and a configuration into set-up, timed steps and the outputs that
are judged.

A ``Runner(cfg, traffic, seed, devices)`` gets the cell's devices, one a
chip (``harness.cell_devices``: a one-chip kind uses ``devices[0]``, a
kind on several cards makes its mesh of them with
``make_mesh(devices=devices)``), and has ``setup()``; ``prepare()``
(the next step's inputs, untimed); ``step()`` (one timed step, ending
synchronized, returning its record: ``units``, ``flops``, ``tiles`` and
``vjps`` (the launches of the two kernels, as (n, m, d, self) and (n, d)
shapes) and ``norm`` (the divisor of ``linalg_ms``));
``after(rec)`` (untimed bookkeeping, setting ``rec["finite"]``);
``end_to_end(records, window_s)``; ``release()`` (drops the program's
state, keeping the outputs to be judged); ``judged_outputs()``,
``reference_outputs(prec)`` and ``compare(outputs, reference)``.
"""
