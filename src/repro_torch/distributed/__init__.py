"""Distribution: sharding rules as DTensor placements, and collective
accounting (the counterpart of `repro.distributed`)."""
