"""Line-oriented text IO (utils/file_utils.lua parity).

The port's own copy of ``rau_vqa_tpu/utils/file_utils.py`` (:1-27).  The
reference ships ``text_read``/``write_text`` (file_utils.lua:4-21) and never
calls them from any experiment script; they are here so that tooling that
used them finds the same contract: read a file into a list of lines (no
trailing newlines), write a list of lines with a trailing newline each.
"""

from __future__ import annotations

from typing import Iterable, List


def text_read(filename: str) -> List[str]:
    """File -> list of lines without newline characters
    (file_utils.lua:4-14)."""
    with open(filename, "r") as f:
        return f.read().splitlines()


def write_text(filename: str, lines: Iterable[str]) -> None:
    """Write one line per entry, each newline-terminated
    (file_utils.lua:16-21)."""
    with open(filename, "w") as f:
        for line in lines:
            f.write(f"{line}\n")
