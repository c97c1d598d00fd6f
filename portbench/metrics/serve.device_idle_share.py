"""The share of the traced stretch of a serving cell in which no kernel or
copy ran on the card: host time the serving entry does not hide."""


def read(view):
    share = view.idle_share()
    return None if share is None else 100.0 * share
