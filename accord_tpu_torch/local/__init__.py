from accord_tpu_torch.local.status import Status, Durability, Phase
from accord_tpu_torch.local.command import Command, WaitingOn
from accord_tpu_torch.local.store import CommandStore
from accord_tpu_torch.local.stores import CommandStores
from accord_tpu_torch.local.node import Node

__all__ = ["Status", "Durability", "Phase", "Command", "WaitingOn",
           "CommandStore", "CommandStores", "Node"]
