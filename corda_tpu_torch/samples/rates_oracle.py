"""Interest-rates oracle: the data classes of its queries and commands.

Port of the wire types of corda_tpu/samples/rates_oracle.py, registered
under the same names (``oracle.FixOf``, ``oracle.Fix``) with the same
field order, so a ``Fix`` command hashes to the same Merkle leaf in both
packages. Reference parity: samples/irs-demo NodeInterestRates (FixOf, Fix).
The oracle service (``RatesOracle``: query, sign, the bulk ``sign_batch``
over ``core.transactions.batch_merkle.verify_filtered_batch``), its
``QueryRequest``/``SignRequest`` messages and its flows come with the flow
framework.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.structures import CommandData
from ..core.serialization import register_type


@dataclass(frozen=True)
class FixOf:
    """Identifies a fix: name + day + tenor (NodeInterestRates FixOf)."""

    name: str
    for_day: str          # ISO date string (deterministic wire form)
    tenor: str            # e.g. "3M"


@dataclass(frozen=True)
class Fix(CommandData):
    """An observed rate embedded as a command (reference Fix)."""

    of: FixOf
    value_bp: int         # basis points — integer, consensus-safe


for _cls in (FixOf, Fix):
    register_type(f"oracle.{_cls.__name__}", _cls)
