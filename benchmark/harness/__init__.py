"""The benchmark's harness: the manifest, the fixture traffic, seeded
weights, the drive of one run, the traced slice and the yardstick."""
