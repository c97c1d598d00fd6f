"""Device-idle milliseconds a serving step spends while the host is inside
the program's ``predict.step`` span, per traced step: the idle gaps that
the trace labels with ``predict.step`` or a span inside it (each gap by the
innermost range at its middle).  Left out where the program has no such
spans, or the trace saw no device work."""

# predict.step and the spans nested in it (eval/predict.py)
SPANS = ("predict.step", "predict.place", "predict.weights", "predict.encoder",
         "predict.embed_image", "predict.hops", "predict.aggregate")


def read(view):
    if view.steps <= 0 or view.busy_s <= 0 or not set(SPANS) & set(view.gaps):
        return None
    return 1e3 * sum(view.gaps.get(s, 0.0) for s in SPANS) / view.steps
