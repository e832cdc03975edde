// The instances of DALTON's filter K8 (dalton_filter_batch.cuh) for
// SEIRAH at q = 3, under kramer and rodeo, with and without data.
#include "dalton_filter_batch.cuh"

namespace rodeo {

template struct DaltonFilterInstances<Seirah, 3>;

}  // namespace rodeo
