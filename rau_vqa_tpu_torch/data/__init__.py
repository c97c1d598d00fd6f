"""Data loading: the prepro bundle, feature stores, the Torch7 reader and
the fixture generator."""
