"""Shortest-path planning on the birdseye grid (counterpart of the JAX package's ``planner``)."""
