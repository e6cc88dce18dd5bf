"""The plain ESN and its MIMO detection harness."""
