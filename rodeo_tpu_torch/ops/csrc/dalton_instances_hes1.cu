// The instances of DALTON's filter K8 (dalton_filter_batch.cuh) for
// Hes1 at q = 3, under kramer and rodeo, with and without data.
#include "dalton_filter_batch.cuh"

namespace rodeo {

template struct DaltonFilterInstances<Hes1, 3>;

}  // namespace rodeo
