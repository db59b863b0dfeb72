"""Strategies of the EP layer (importing a module registers it)."""
