"""Device-idle milliseconds a training step spends while the host is inside
the program's per-group ``trainer.noise``, ``trainer.clip`` and
``trainer.adam`` spans, per traced step: the idle gaps the trace labels
with them (each gap by the innermost range at its middle).  Left out where
the program has no ``trainer.*`` spans, or the trace saw no device work.
The profiler slows the host, so this reads more than the idle of an
untraced step: compare it traced against traced."""

SPANS = ("trainer.noise", "trainer.clip", "trainer.adam")


def read(view):
    if (view.steps <= 0 or view.busy_s <= 0
            or not any(g.startswith("trainer.") for g in view.gaps)):
        return None
    return 1e3 * sum(view.gaps.get(s, 0.0) for s in SPANS) / view.steps
