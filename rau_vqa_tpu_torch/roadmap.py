"""The refusals of options the port does not have yet, each naming the item
of ROADMAP.md's queue 1 that holds the work, so that every refusal of one
kind reads alike and follows the queue when it is reordered.  Items 5 and 8
(fine-tuning; export, the benches and the rig tools) are done and refuse
nothing; the items keep their numbers."""

from __future__ import annotations

ITEMS = {"transforms": 6, "multi-device": 7}


def still_to_port(what: str, item: str) -> str:
    """'<what> is still to port (ROADMAP.md, queue 1, item N, <item>)'."""
    return f"{what} is still to port (ROADMAP.md, queue 1, item {ITEMS[item]}, {item})"
