"""Factories, CLI glue, checkpoint loading and weight conversion."""
