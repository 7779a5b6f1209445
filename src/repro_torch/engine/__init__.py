"""The interval controller and the simulation loop of Layer A."""
