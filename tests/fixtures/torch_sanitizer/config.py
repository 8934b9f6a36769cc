"""Planted KEY002: a config that hashes by identity (not frozen)."""

from dataclasses import dataclass


@dataclass
class EngineConfig:  # PLANT: KEY002
    frontier: int = 32
    gens: int = 48
    edit_budget: int = 0
