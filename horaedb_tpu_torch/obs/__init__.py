"""Device-plane observability (obs/device): HBM occupancy, kernel
timing, and compile accounting as first-class observables."""
