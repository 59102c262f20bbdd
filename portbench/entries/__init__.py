"""The program's entries that a traffic mix can drive, one module each,
found by the mix's ``"entry"``. A module gives:

- ``CONTROL``: the guarantee its control breaks (``harness/reference.py``);
- ``jobs(seed, mix, config, workers)`` and ``chunk(job)``: the input
  makers, run on the process pool; ``chunk`` returns rows whose first field
  is the input's index;
- ``prepare(rows, seed, mix, config)``: a ``Prepared`` of the rows;
- ``build_target(config, mix, device)``, ``batcher_of(target)`` and
  ``close_target(target)``: the system under test;
- ``submitter(target, mix, program_inputs)``: submit(k) -> Future of
  distinct input k; ``outcome_reader(mix)``: outcome(future) -> verdict;
- ``reference(pool, plain, mix, control=None)``: the plain reference's
  verdict of each distinct input;
- ``judge(answers, expected)``: (wrong verdicts, failed items) of the
  answers [(k, verdict)]; ``mismatches(a, b)``: items on which two
  verdicts of one input differ.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass
class Prepared:
    """The inputs of one run, as the program and the reference take them."""

    program_inputs: object     # what submit(k) hands the program
    plain: list                # the plain description the reference judges
    labels: list               # what each distinct input was built to be
    n_distinct: int            # submissions the loop cycles through
    per_submission: int        # items one submission carries


def load(name: str):
    if not name.isidentifier():
        raise ValueError(f"no entry {name!r}")
    return importlib.import_module(f"entries.{name}")
