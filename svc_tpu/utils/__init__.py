"""Utility layer: scalar math helpers, error types, CLI parsing.

Counterpart of the reference's L0 utility layer
(libs/types.hpp, libs/math.hpp, libs/error.hpp, libs/cli.hpp).
"""
