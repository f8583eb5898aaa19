"""The benchmark of ilqr_planner_torch: see README.md."""
