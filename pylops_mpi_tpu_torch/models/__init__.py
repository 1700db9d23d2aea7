"""Application pipelines — analogs of the reference's tutorials."""
from .poststack import (PoststackLinearModelling, MPIPoststackLinearModelling,
                        poststack_inversion, ricker)

__all__ = ["PoststackLinearModelling", "MPIPoststackLinearModelling",
           "poststack_inversion", "ricker"]
