"""Recipes of the port: model construction per experiment family."""
