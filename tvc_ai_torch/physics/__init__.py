"""6-DOF quaternion rigid-body physics core."""
