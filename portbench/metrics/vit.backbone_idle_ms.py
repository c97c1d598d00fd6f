"""Device-idle milliseconds a from-pixels request spends while the host is
inside the program's ``pipeline.backbone`` span or a tower's spans in it
(``vit.patch_embed``, ``vit.attention``, ``vit.mlp``, ``vit.final_ln``),
per traced request: the idle gaps the trace labels with them (each gap by
the innermost range at its middle); 0 where none is.  Left out where the
trace saw no device work."""

SPANS = ("pipeline.backbone", "vit.patch_embed", "vit.attention", "vit.mlp", "vit.final_ln")


def read(view):
    if view.steps <= 0 or view.busy_s <= 0:
        return None
    return 1e3 * sum(view.gaps.get(s, 0.0) for s in SPANS) / view.steps
