"""The replica side of the serving data plane: the HTTP endpoint a
gateway dispatches to, in front of the port's paged batcher."""
