"""The IHTC pipeline of the port: kNN, TC, prototypes, ITIS, planner,
memory executor and the servable index."""
