"""The port's measurement and experiment scripts, one module a script of the
JAX side's ``scripts/`` under its name:
``python3 -m rau_vqa_tpu_torch.scripts.<name> [--device cpu] ...``.  Each runs
on the card unless ``--device cpu`` is given, prints its progress on stderr
and one JSON line last on stdout."""
