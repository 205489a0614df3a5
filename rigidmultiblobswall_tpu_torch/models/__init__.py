"""Models: system description, kinematics, saddle operator, solvers, integrators."""
