"""Benchmark harness utilities: CSV emission per paper table/figure."""
from __future__ import annotations


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.3f},{derived}")


def header() -> None:
    print("name,us_per_call,derived")
