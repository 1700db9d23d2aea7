"""Application pipelines — analogs of the reference's tutorials."""
from .poststack import (PoststackLinearModelling, MPIPoststackLinearModelling,
                        poststack_inversion, ricker)
from .mdd import mdd, kernel_to_frequency
from .lsm import TravelTimeSpray, KirchhoffDemigration, MPILSM, lsm

__all__ = ["PoststackLinearModelling", "MPIPoststackLinearModelling",
           "poststack_inversion", "ricker", "mdd", "kernel_to_frequency",
           "TravelTimeSpray", "KirchhoffDemigration", "MPILSM", "lsm"]
