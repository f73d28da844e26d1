"""Point-cloud ops: FPS and the nearest-neighbour scans, each with its kernel."""
