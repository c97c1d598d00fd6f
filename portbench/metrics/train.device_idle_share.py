"""The share of the traced stretch of the training cell in which no kernel or
copy ran on the card: host time the training step does not hide."""


def read(view):
    share = view.idle_share()
    return None if share is None else 100.0 * share
