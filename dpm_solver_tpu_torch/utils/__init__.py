"""Small helpers of the port: tensor broadcasting and the Flax -> torch weight bridge."""
