"""Algebraic setup: host level loop, splittings, hierarchy."""
